"""chip_smoke.py's four-card phases rehearsed on 4 virtual CPU devices."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

TINY = dict(nrows=1200, ncols=800, row_density=12, seed=42)


@pytest.mark.parametrize("prime,n", smoke.FOUR_CARD_FIELDS)
def test_mesh_parity_on_four_devices(prime, n):
    M = smoke.random_coo(**TINY, prime=prime)
    jobs = {tag: smoke.partial(smoke.built_and_compiled, make) for tag, make
            in smoke.mesh_layouts(M, n, ((4, 1), (2, 2))).items()}
    jobs["ref"] = lambda: smoke.one_card_reference(M, n, 3)
    built = smoke.in_threads(jobs)
    ref = built.pop("ref")
    assert all(secs > 0 for _, secs in built.values())
    solvers = {tag: solver for tag, (solver, _) in built.items()}
    out = smoke.phase_mesh_parity(ref, solvers, 3, loop_iters=5)
    assert [k for k in out if k.endswith("_smoke_s_per_iter")] == [
        f"{g}_smoke_s_per_iter" for g in
        ("4x1", "4x1+overlap", "2x2", "2x2+overlap")]
    assert solvers == {}


def test_mesh_parity_catches_a_different_block():
    M = smoke.random_coo(**TINY, prime=smoke.P_NARROW)
    solvers = {tag: smoke.built_and_compiled(make)[0] for tag, make
               in smoke.mesh_layouts(M, 4, ((4, 1),)).items()}
    ref = smoke.one_card_reference(M, 4, 3).copy()
    ref[0, 0] ^= 1
    with pytest.raises(smoke.PhaseFailed, match="differs"):
        smoke.phase_mesh_parity(ref, solvers, 3, loop_iters=2)


def test_gf2_mesh_scale_four_vs_one():
    M = smoke.random_coo(nrows=3000, ncols=2000, row_density=17, seed=42,
                         prime=2)
    solvers = {k: smoke.ShardedBlockLanczosGF2(M, n=128,
                                               mesh=smoke.make_mesh(k))
               for k in (1, 4)}
    out = smoke.phase_gf2_mesh_scale(solvers, 3)
    assert "bit-exact" in out["check"]
    assert out["1card_smoke_s_per_iter"] > 0
    assert out["4card_smoke_s_per_iter"] > 0


def test_run_four_cards_tiny(tmp_path):
    """The --four driver end to end on 4 virtual devices: mesh parity per
    field, GF(2) 4 vs 1 device, a checked --devices 4 CLI solve that is
    byte-identical with the same solve as 2 processes x 2 devices."""
    mtx = smoke.write_matrix(TINY, str(tmp_path / "m.mtx"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    two = smoke.phase_two_process(
        mtx, smoke.P_NARROW, 32, str(tmp_path), lambda i: env,
        extra=("--no-checks", "--local-devices", "2"))
    r = smoke.Runner()
    smoke.run_four_cards(r, str(tmp_path), mtx, two, spec=TINY,
                         scale_spec=TINY, iters=2)
    assert r.failed == []
