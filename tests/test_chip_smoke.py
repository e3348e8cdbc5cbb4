"""chip_smoke.py on the CPU: its phases at tiny sizes, its refusal to run
without a GPU, the compile-cache helper, and bench.py's refusal."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

TINY = dict(nrows=3000, ncols=2000, row_density=15, seed=42)


@pytest.fixture(scope="module")
def tiny_mtx(tmp_path_factory):
    return smoke.write_matrix(TINY, str(tmp_path_factory.mktemp("m") / "m.mtx"))


def _cpu_env(**extra):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def test_phase_golden_byte_identical(tmp_path):
    out = smoke.phase_golden("left_p65537_n4", 65537, 4, False, str(tmp_path))
    assert out["iterations"] > 0


@pytest.mark.parametrize("prime,n", [(smoke.P_NARROW, 32), (2, 128),
                                     (smoke.P_WIDE, 4)])
def test_phase_cli_solve_passes_checker(tmp_path, tiny_mtx, prime, n):
    out = smoke.phase_cli_solve(tiny_mtx, prime, n, str(tmp_path), "k")
    assert out["check"] == "checker OK" and os.path.exists(out["output"])


def test_phase_cli_solve_rejects_a_wrong_kernel(tmp_path, tiny_mtx,
                                                monkeypatch):
    """A kernel the checker refuses fails the phase."""
    real = smoke.cli.main

    def corrupt(argv):
        rc = real(argv)
        path = argv[argv.index("--output-file") + 1]
        with open(path) as fh:
            lines = fh.read().split("\n")
        lines[3] = str(int(lines[3]) ^ 1)   # first entry after the header
        with open(path, "w") as fh:
            fh.write("\n".join(lines))
        return rc
    monkeypatch.setattr(smoke.cli, "main", corrupt)
    with pytest.raises(smoke.PhaseFailed, match="checker"):
        smoke.phase_cli_solve(tiny_mtx, smoke.P_NARROW, 4, str(tmp_path), "k")


def test_phase_cli_stop_after(tmp_path, tiny_mtx):
    out = smoke.phase_cli_stop_after(tiny_mtx, smoke.P_WIDE, 4, 5,
                                     str(tmp_path))
    assert out["iterations"] == 5


@pytest.mark.parametrize("n", [4, 32])
def test_phase_gram_matches_host(n):
    out = smoke.phase_gram(n, 9000)
    assert out["smoke_s_per_call"] > 0


def test_np_gram_mod_is_exact():
    from block_lanczos_tpu.ops.gfp import np_matmul_mod
    p = smoke.P_NARROW
    rng = np.random.default_rng(1)
    V = rng.integers(0, p, (500, 6), dtype=np.uint32)
    W = rng.integers(0, p, (500, 3), dtype=np.uint32)
    np.testing.assert_array_equal(smoke.np_gram_mod(p, V, W),
                                  np_matmul_mod(p, V.T, W))


def test_phase_single_vs_mesh(tiny_mtx):
    M = smoke.mmio.load_mtx(tiny_mtx, smoke.P_NARROW)
    out = smoke.phase_single_vs_mesh(M, 4, 6, smoke.CompileClock())
    assert out["single_smoke_s_per_iter"] > 0
    assert out["mesh1x1_smoke_s_per_iter"] > 0


def test_phase_loop_floor():
    out = smoke.phase_iteration_floor(smoke.SMALL, iters=50)
    assert out["iters"] == 50 and out["smoke_s_per_iter"] > 0


def test_phase_gf2_at_scale_tiny():
    out = smoke.phase_gf2_at_scale(
        dict(nrows=4000, ncols=3000, row_density=17, seed=42), (128, 256), 3,
        loop_iters=5)
    assert out["operator_bytes"] > 0
    assert out["n128_compile_s"] > 0 and out["n256_smoke_s_per_iter"] > 0
    assert "n256_process_peak_bytes" in out


def test_runner_reports_failure_and_continues(capsys):
    r = smoke.Runner()

    def boom():
        raise smoke.PhaseFailed("differs")
    r.run("a", boom)
    r.run("b", lambda: {"check": "fine"})
    lines = [json.loads(x[len("smoke "):]) for x in
             capsys.readouterr().out.splitlines() if x.startswith("smoke ")]
    assert [x["status"] for x in lines] == ["FAIL", "PASS"]
    assert r.failed == ["a"]


def test_main_refuses_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_without_gpu():
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


_PRINT_CACHE = ("from block_lanczos_tpu.utils.compile_cache import "
                "enable_compile_cache; import jax; p = enable_compile_cache(); "
                "print(p); print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_fixed_path_when_unset(tmp_path):
    outs = []
    for cwd in (REPO, str(tmp_path)):   # same path from any directory
        r = subprocess.run([sys.executable, "-c", _PRINT_CACHE], cwd=cwd,
                           env=_cpu_env(PYTHONPATH=REPO), capture_output=True,
                           text=True, timeout=120, check=True)
        outs.append(r.stdout.split())
    assert outs[0] == outs[1]
    assert outs[0] == [os.path.join(REPO, ".jax_cache")] * 2


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache")
    r = subprocess.run([sys.executable, "-c", _PRINT_CACHE], cwd=REPO,
                       env=_cpu_env(JAX_COMPILATION_CACHE_DIR=want),
                       capture_output=True, text=True, timeout=120,
                       check=True)
    assert r.stdout.split() == [want, want]
