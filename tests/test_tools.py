"""Tests for matrix_tool CLI and profiling helpers."""

import os

import numpy as np
import pytest

from block_lanczos_tpu.utils import matrix_tool, mmio
from block_lanczos_tpu.utils.gen import random_coo, write_random_mtx

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_generate_and_info(tmp_path, capsys):
    out = str(tmp_path / "g.mtx")
    rc = matrix_tool.main(["generate", "--out", out, "--nrows", "50",
                           "--ncols", "30", "--row-density", "4"])
    assert rc == 0
    nr, nc, nnz = mmio.read_mtx_header(out)
    assert (nr, nc) == (50, 30) and nnz > 0
    rc = matrix_tool.main(["info", "--matrix", out, "--prime", "65537"])
    assert rc == 0
    assert "nnz/row" in capsys.readouterr().out


def test_check_subcommand(tmp_path):
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    kern = os.path.join(GOLDEN, "left_p65537_n4.kernel.mtx")
    assert matrix_tool.main(["check", "--matrix", mtx, "--kernel", kern,
                             "--prime", "65537"]) == 0
    # corrupt kernel fails
    _, _, data = mmio.read_array_mtx(kern)
    bad = str(tmp_path / "bad.mtx")
    data[0, 0] = (data[0, 0] + 1) % 65537
    mmio.write_kernel_mtx(bad, data.astype(np.uint32), data.shape[0], 4)
    assert matrix_tool.main(["check", "--matrix", mtx, "--kernel", bad,
                             "--prime", "65537"]) == 1


def test_phase_timers():
    from block_lanczos_tpu.models.lanczos import BlockLanczos
    from block_lanczos_tpu.utils.profiling import phase_timers
    M = mmio.load_mtx(os.path.join(GOLDEN, "left_p65537_n4.mtx"), 65537)
    rep = phase_timers(BlockLanczos(M, n=4), iters=1)
    assert set(rep) >= {"spmv_first_s", "gram_s", "semi_inverse_s",
                        "orthogonalize_s", "total_s", "spmv_share",
                        "spmv_nnz_per_s"}
    assert rep["total_s"] > 0 and 0 < rep["spmv_share"] < 1


@pytest.mark.parametrize("prime", [65537, (1 << 61) - 1, 2])
def test_random_coo_matches_the_written_matrix(tmp_path, prime):
    """random_coo builds in memory what write_random_mtx + load_mtx give."""
    path = str(tmp_path / "m.mtx")
    write_random_mtx(path, 120, 80, 6, seed=9)
    want = mmio.load_mtx(path, prime)
    got = random_coo(120, 80, 6, prime, seed=9)
    assert (got.nrows, got.ncols, got.nnz) == (want.nrows, want.ncols,
                                               want.nnz)
    for M in (got, want):
        order = np.lexsort((M.j, M.i))
        M.i, M.j, M.x = M.i[order], M.j[order], M.x[order]
    np.testing.assert_array_equal(got.i, want.i)
    np.testing.assert_array_equal(got.j, want.j)
    np.testing.assert_array_equal(got.x.astype(np.uint64),
                                  want.x.astype(np.uint64))


def _loop_solver(kind, M):
    from block_lanczos_tpu.models.lanczos import BlockLanczos
    from block_lanczos_tpu.models.lanczos_gf2 import BlockLanczosGF2
    from block_lanczos_tpu.models.lanczos_wide import BlockLanczosWide
    from block_lanczos_tpu.parallel.distributed import ShardedBlockLanczos
    from block_lanczos_tpu.parallel.mesh import make_mesh
    return {"narrow": lambda: BlockLanczos(M, n=4),
            "narrow_mesh": lambda: ShardedBlockLanczos(M, n=4,
                                                       mesh=make_mesh(1)),
            "gf2": lambda: BlockLanczosGF2(M, n=64),
            "wide": lambda: BlockLanczosWide(M, n=4)}[kind]()


@pytest.mark.parametrize("kind,prime", [("narrow", 65537),
                                        ("narrow_mesh", 65537), ("gf2", 2),
                                        ("wide", (1 << 61) - 1)])
def test_loop_s_per_iter_runs_the_window(kind, prime):
    """The timed dispatch runs exactly the requested iterations."""
    from block_lanczos_tpu.utils.profiling import loop_s_per_iter, solver_loop
    solver = _loop_solver(kind, random_coo(600, 400, 8, prime, seed=3))
    s_iter, done = loop_s_per_iter(*solver_loop(solver), 5, warmup=2)
    assert done == 5 and s_iter > 0


def test_loop_s_per_iter_stops_at_convergence():
    """A window longer than the solve reports the iterations it ran."""
    from block_lanczos_tpu.utils.profiling import loop_s_per_iter, solver_loop
    M = mmio.load_mtx(os.path.join(GOLDEN, "left_p65537_n4.mtx"), 65537)
    solver = _loop_solver("narrow", M)
    _, done = loop_s_per_iter(*solver_loop(solver), 100_000, warmup=1)
    assert 0 < done < solver.expected_iterations + 10
