"""Golden parity on the card: the CLI on a GPU reproduces the C reference.

Every committed golden (narrow primes, generic p=2, bitsliced GF(2)) runs
through the CLI on the GPU and its kernel file must equal the reference's
byte for byte; the wide field, which the reference cannot run, is held to
the independent checker.  Skips without a GPU.  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import os

import pytest

from block_lanczos_tpu.utils import checker, cli
from block_lanczos_tpu.utils.gen import write_random_mtx

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

with open(os.path.join(GOLDEN, "MANIFEST.txt")) as _fh:
    CONFIGS = [row.split() for row in _fh if row.strip()]

pytestmark = pytest.mark.gpu


@pytest.fixture
def on_gpu():
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {platform}")


@pytest.mark.parametrize("name,prime,n,right", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_golden_parity_on_gpu(on_gpu, tmp_path, name, prime, n, right):
    out = str(tmp_path / "k.mtx")
    argv = ["--matrix", os.path.join(GOLDEN, f"{name}.mtx"),
            "--prime", prime, "--n", n, "--output-file", out]
    if right == "True":
        argv.append("--right")
    assert cli.main(argv) == 0
    with open(out, "rb") as got, \
            open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as want:
        assert got.read() == want.read()


def test_wide_field_solve_on_gpu(on_gpu, tmp_path):
    mtx, out = str(tmp_path / "m.mtx"), str(tmp_path / "k.mtx")
    prime = (1 << 61) - 1
    write_random_mtx(mtx, 300, 200, 8, seed=3)
    assert cli.main(["--matrix", mtx, "--prime", str(prime), "--n", "4",
                     "--output-file", out]) == 0
    assert checker.check_kernel_file(mtx, out, prime)
