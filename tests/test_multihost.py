"""Multi-host (multi-controller) execution tests.

Spawns REAL separate processes that join a jax.distributed coordinator and
solve over a process-spanning CPU mesh — the equivalent of the
reference's mpiexec runs (reference: mpi/lanczos_modp.c:505-566 grid init,
README.md:39-46).  Golden parity: the 2-process x 4-device kernel must be
byte-identical to the single-process result (exact mod-p arithmetic makes
this deterministic for ANY process/device split).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from block_lanczos_tpu.utils import checkpoint as ckpt
from block_lanczos_tpu.utils import mmio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_procs(num_processes: int, local_devices: int, common_args: list,
               timeout: float = 420.0):
    """Launch one CLI process per rank against a shared coordinator."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # --local-devices supplies the device count
    procs = []
    for pid in range(num_processes):
        argv = [sys.executable, "-m", "block_lanczos_tpu.utils.cli",
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(num_processes),
                "--process-id", str(pid),
                "--local-devices", str(local_devices)] + common_args
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{out}"
    return outs


@pytest.mark.slow
def test_two_process_golden_parity(tmp_path):
    """2 processes x 4 CPU devices: kernel byte-identical to the golden."""
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    out = str(tmp_path / "k_mp.mtx")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", "65537", "--n", "4",
                      "--devices", "8", "--output-file", out, "--no-checks"])
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, "left_p65537_n4.kernel.mtx"), "rb") as f:
        ref = f.read()
    assert got == ref


@pytest.mark.slow
def test_two_process_2d_grid_and_checkpoint_resume(tmp_path):
    """2 processes on a 2x4 grid, per-host sharded checkpoint, resume across
    processes; final kernel matches the golden byte-for-byte."""
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    ckdir = str(tmp_path / "ck")
    # phase 1: stop early with aggressive checkpointing
    _run_procs(2, 4, ["--matrix", mtx, "--prime", "65537", "--n", "4",
                      "--grid", "2", "4", "--stop-after", "6",
                      "--sync-every", "2", "--checkpoint", "0",
                      "--checkpoint-dir", ckdir, "--no-checks"])
    state = ckpt.load_checkpoint(ckdir)
    assert state["iteration"] > 0
    assert state["shard_files"] == 2          # per-host shard format
    assert state["field"] == "narrow"
    # both processes contributed shard files
    step_dir = os.path.join(ckdir, state["step_dir"])
    assert sorted(os.listdir(step_dir)) == ["shard_0.npz", "shard_1.npz"]
    # phase 2: resume with 2 processes to completion
    out = str(tmp_path / "k_resume.mtx")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", "65537", "--n", "4",
                      "--grid", "2", "4", "--load-checkpoint",
                      "--checkpoint-dir", ckdir,
                      "--output-file", out, "--no-checks"])
    _, _, got = mmio.read_array_mtx(out)
    _, _, ref = mmio.read_array_mtx(
        os.path.join(GOLDEN, "left_p65537_n4.kernel.mtx"))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.slow
def test_two_process_shard_local_build(tmp_path):
    """Each process materializes ONLY its addressable matrix blocks
    (round-3 shard-local build; round 2 built all R x C on every host —
    the reference's root at least carved once, mpi/lanczos_modp.c:623-792).
    Output must still be byte-identical to the golden."""
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    out = str(tmp_path / "k_local.mtx")
    outs = _run_procs(2, 4, ["--matrix", mtx, "--prime", "65537", "--n", "4",
                             "--devices", "8", "--output-file", out,
                             "--no-checks"])
    for o in outs:
        assert "materializing 4/8 matrix blocks" in o, o
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, "left_p65537_n4.kernel.mtx"), "rb") as f:
        ref = f.read()
    assert got == ref


def test_local_build_path_matches_replicated(monkeypatch):
    """The shard-local build (count-model statics + per-shard callbacks)
    is bit-identical to the replicated build — forced on in-process by
    faking the addressable set to all blocks."""
    from block_lanczos_tpu.parallel import sharding as shard_lib
    from block_lanczos_tpu.parallel.distributed import ShardedBlockLanczos
    from block_lanczos_tpu.parallel.mesh import make_mesh_grid

    M = mmio.load_mtx(os.path.join(GOLDEN, "left_p65537_n4.mtx"), 65537)
    ref = ShardedBlockLanczos(M, n=4, mesh=make_mesh_grid(4, 2)).solve()
    monkeypatch.setattr(
        shard_lib, "_addressable_parts",
        lambda mesh: {(r, c) for r in range(4) for c in range(2)})
    res = ShardedBlockLanczos(M, n=4, mesh=make_mesh_grid(4, 2)).solve()
    np.testing.assert_array_equal(res.kernel, ref.kernel)
    assert res.iterations == ref.iterations


@pytest.mark.slow
def test_sharded_checkpoint_resumes_single_process(tmp_path):
    """A checkpoint written by 2 processes resumes in ONE process (mesh-shape
    independence of the snapshot: global arrays, not rank-local state)."""
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    ckdir = str(tmp_path / "ck")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", "65537", "--n", "4",
                      "--devices", "8", "--stop-after", "6",
                      "--sync-every", "2", "--checkpoint", "0",
                      "--checkpoint-dir", ckdir, "--no-checks"])
    from block_lanczos_tpu.models.lanczos import BlockLanczos
    M = mmio.load_mtx(mtx, 65537)
    state = ckpt.load_checkpoint(ckdir)
    resumed = BlockLanczos(M, n=4).solve(resume_state=state)
    full = BlockLanczos(M, n=4).solve()
    assert resumed.iterations == full.iterations
    np.testing.assert_array_equal(resumed.kernel, full.kernel)


# ---------------------------------------------------------------------------
# Round 4: the wide and GF(2) mesh solvers under REAL jax.distributed
# processes (round 3 covered the narrow field only).  Reference analogue:
# any variant runs under mpiexec (mpi/lanczos_modp.c:505-566, README.md:39-46).
# ---------------------------------------------------------------------------

WIDE_P = (1 << 61) - 1


def test_local_build_gf2_matches_replicated(monkeypatch):
    """GF(2) shard-local build (count-model statics + per-shard callbacks)
    is bit-identical to the replicated build."""
    from block_lanczos_tpu.parallel import sharding as shard_lib
    from block_lanczos_tpu.parallel.distributed_gf2 import ShardedBlockLanczosGF2
    from block_lanczos_tpu.parallel.mesh import make_mesh_grid

    M = mmio.load_mtx(os.path.join(GOLDEN, "left_p2_n32.mtx"), 2)
    ref = ShardedBlockLanczosGF2(M, n=32, mesh=make_mesh_grid(4, 2)).solve()
    monkeypatch.setattr(
        shard_lib, "_addressable_parts",
        lambda mesh: {(r, c) for r in range(4) for c in range(2)})
    res = ShardedBlockLanczosGF2(M, n=32, mesh=make_mesh_grid(4, 2)).solve()
    np.testing.assert_array_equal(res.kernel, ref.kernel)
    assert res.iterations == ref.iterations


def test_local_build_wide_matches_replicated(monkeypatch):
    """Wide shard-local build (ell clamp folded into the agreed width) is
    bit-identical to the replicated build."""
    from block_lanczos_tpu.parallel import sharding as shard_lib
    from block_lanczos_tpu.parallel.distributed_wide import ShardedBlockLanczosWide
    from block_lanczos_tpu.parallel.mesh import make_mesh_grid

    M = mmio.load_mtx(os.path.join(GOLDEN, "left_pbig_n4.mtx"), WIDE_P)
    ref = ShardedBlockLanczosWide(M, n=4, mesh=make_mesh_grid(4, 2)).solve()
    monkeypatch.setattr(
        shard_lib, "_addressable_parts",
        lambda mesh: {(r, c) for r in range(4) for c in range(2)})
    res = ShardedBlockLanczosWide(M, n=4, mesh=make_mesh_grid(4, 2)).solve()
    np.testing.assert_array_equal(res.kernel, ref.kernel)
    assert res.iterations == ref.iterations


def test_local_build_overlap_matches_replicated(monkeypatch):
    """Overlap-mode shard-local build is bit-identical to the replicated
    build (the overlap partitioner splits each direction in two)."""
    from block_lanczos_tpu.parallel import sharding as shard_lib
    from block_lanczos_tpu.parallel.distributed import ShardedBlockLanczos
    from block_lanczos_tpu.parallel.mesh import make_mesh_grid

    M = mmio.load_mtx(os.path.join(GOLDEN, "left_p65537_n4.mtx"), 65537)
    ref = ShardedBlockLanczos(M, n=4, mesh=make_mesh_grid(4, 2),
                              overlap=True).solve()
    monkeypatch.setattr(
        shard_lib, "_addressable_parts",
        lambda mesh: {(r, c) for r in range(4) for c in range(2)})
    res = ShardedBlockLanczos(M, n=4, mesh=make_mesh_grid(4, 2),
                              overlap=True).solve()
    np.testing.assert_array_equal(res.kernel, ref.kernel)
    assert res.iterations == ref.iterations


@pytest.mark.slow
def test_two_process_gf2_golden_parity_and_local_build(tmp_path):
    """GF(2) bitsliced mesh solver under 2 real processes: byte-identical to
    the committed reference golden, with each process materializing only its
    addressable matrix blocks."""
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    out = str(tmp_path / "k_gf2_mp.mtx")
    outs = _run_procs(2, 4, ["--matrix", mtx, "--prime", "2", "--n", "32",
                             "--devices", "8", "--output-file", out,
                             "--no-checks"])
    for o in outs:
        assert "materializing 4/8 matrix blocks" in o, o
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, "left_p2_n32.kernel.mtx"), "rb") as f:
        ref = f.read()
    assert got == ref


@pytest.mark.slow
def test_two_process_wide_parity_and_local_build(tmp_path):
    """Wide-field mesh solver under 2 real processes: byte-identical to the
    single-process solve at the same prime (the reference cannot run wide
    primes at all — self-parity is the oracle), shard-local build active,
    and the kernel validates with the independent checker."""
    from block_lanczos_tpu.utils import checker, cli
    mtx = os.path.join(GOLDEN, "left_pbig_n4.mtx")
    ref_out = str(tmp_path / "k_wide_1p.mtx")
    rc = cli.main(["--matrix", mtx, "--prime", str(WIDE_P), "--n", "4",
                   "--devices", "8", "--output-file", ref_out, "--no-checks"])
    assert rc == 0
    out = str(tmp_path / "k_wide_mp.mtx")
    outs = _run_procs(2, 4, ["--matrix", mtx, "--prime", str(WIDE_P),
                             "--n", "4", "--devices", "8",
                             "--output-file", out, "--no-checks"])
    for o in outs:
        assert "materializing 4/8 matrix blocks" in o, o
    with open(out, "rb") as f:
        got = f.read()
    with open(ref_out, "rb") as f:
        ref = f.read()
    assert got == ref
    assert checker.check_kernel_file(mtx, out, WIDE_P) is True


@pytest.mark.slow
def test_two_process_gf2_checkpoint_resume(tmp_path):
    """GF(2): per-host sharded checkpoint written by 2 processes, resumed by
    2 processes, final kernel byte-identical to the reference golden."""
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    ckdir = str(tmp_path / "ck")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", "2", "--n", "32",
                      "--devices", "8", "--stop-after", "2",
                      "--sync-every", "1", "--checkpoint", "0",
                      "--checkpoint-dir", ckdir, "--no-checks"])
    state = ckpt.load_checkpoint(ckdir)
    assert state["iteration"] > 0
    assert state["shard_files"] == 2
    assert state["field"] == "gf2"
    out = str(tmp_path / "k_resume.mtx")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", "2", "--n", "32",
                      "--devices", "8", "--load-checkpoint",
                      "--checkpoint-dir", ckdir,
                      "--output-file", out, "--no-checks"])
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, "left_p2_n32.kernel.mtx"), "rb") as f:
        ref = f.read()
    assert got == ref


@pytest.mark.slow
def test_two_process_wide_checkpoint_resume(tmp_path):
    """Wide field: per-host sharded checkpoint + cross-process resume; the
    resumed kernel equals an uninterrupted single-process solve."""
    from block_lanczos_tpu.utils import cli
    mtx = os.path.join(GOLDEN, "left_pbig_n4.mtx")
    ref_out = str(tmp_path / "k_wide_full.mtx")
    rc = cli.main(["--matrix", mtx, "--prime", str(WIDE_P), "--n", "4",
                   "--devices", "8", "--output-file", ref_out, "--no-checks"])
    assert rc == 0
    ckdir = str(tmp_path / "ck")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", str(WIDE_P), "--n", "4",
                      "--devices", "8", "--stop-after", "6",
                      "--sync-every", "2", "--checkpoint", "0",
                      "--checkpoint-dir", ckdir, "--no-checks"])
    state = ckpt.load_checkpoint(ckdir)
    assert state["iteration"] > 0
    assert state["shard_files"] == 2
    assert state["field"] == "wide"
    out = str(tmp_path / "k_resume.mtx")
    _run_procs(2, 4, ["--matrix", mtx, "--prime", str(WIDE_P), "--n", "4",
                      "--devices", "8", "--load-checkpoint",
                      "--checkpoint-dir", ckdir,
                      "--output-file", out, "--no-checks"])
    with open(out, "rb") as f:
        got = f.read()
    with open(ref_out, "rb") as f:
        ref = f.read()
    assert got == ref


def test_local_build_overlap_gf2_and_wide_matches_replicated(monkeypatch):
    """Shard-local builds under the round-4 GF(2)/wide OVERLAP partitioners
    are bit-identical to the replicated builds (the narrow overlap variant
    is covered above)."""
    from block_lanczos_tpu.parallel import sharding as shard_lib
    from block_lanczos_tpu.parallel.distributed_gf2 import \
        ShardedBlockLanczosGF2
    from block_lanczos_tpu.parallel.distributed_wide import \
        ShardedBlockLanczosWide
    from block_lanczos_tpu.parallel.mesh import make_mesh_grid

    M2 = mmio.load_mtx(os.path.join(GOLDEN, "left_p2_n32.mtx"), 2)
    Mw = mmio.load_mtx(os.path.join(GOLDEN, "left_pbig_n4.mtx"), WIDE_P)
    ref2 = ShardedBlockLanczosGF2(M2, n=32, mesh=make_mesh_grid(4, 2),
                                  overlap=True).solve()
    refw = ShardedBlockLanczosWide(Mw, n=4, mesh=make_mesh_grid(4, 2),
                                   overlap=True).solve()
    monkeypatch.setattr(
        shard_lib, "_addressable_parts",
        lambda mesh: {(r, c) for r in range(4) for c in range(2)})
    got2 = ShardedBlockLanczosGF2(M2, n=32, mesh=make_mesh_grid(4, 2),
                                  overlap=True).solve()
    gotw = ShardedBlockLanczosWide(Mw, n=4, mesh=make_mesh_grid(4, 2),
                                   overlap=True).solve()
    np.testing.assert_array_equal(got2.kernel, ref2.kernel)
    np.testing.assert_array_equal(gotw.kernel, refw.kernel)
