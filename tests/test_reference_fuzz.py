"""Live randomized bit-exact parity fuzz vs the sequential C reference.

Unlike the committed goldens (fixed configs), this builds the reference
binary and compares byte-for-byte on FRESH random instances each run —
exact arithmetic + the shared xoshiro256+ seed make the outputs fully
deterministic per instance, so any divergence is a real bug, never noise.
The instance seed is printed so failures reproduce exactly.

Skipped when the reference sources are unavailable.
"""

import os
import secrets
import subprocess
import sys

import numpy as np
import pytest

from block_lanczos_tpu.utils import gen, mmio

REF_SRC = "/root/reference/sequential"
BUILD_DIR = "/tmp/blanczos_refbench"
BINARY = os.path.join(BUILD_DIR, "lanczos_modp")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_binary():
    if os.path.exists(BINARY):
        return BINARY
    if not os.path.isdir(REF_SRC):
        return None
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            f"cp {REF_SRC}/*.c {REF_SRC}/*.h {REF_SRC}/Makefile {BUILD_DIR}/ "
            f"&& make -C {BUILD_DIR}", shell=True, check=True,
            capture_output=True)
    except subprocess.CalledProcessError:
        return None
    return BINARY if os.path.exists(BINARY) else None


@pytest.mark.slow
def test_fresh_random_instances_bit_exact(tmp_path):
    binary = _reference_binary()
    if binary is None:
        pytest.skip("reference sources/binary unavailable")
    seed = secrets.randbits(31)
    print(f"fuzz seed: {seed}")  # reproduce with this seed on failure
    rng = np.random.default_rng(seed)
    for trial in range(2):
        nr = int(rng.integers(40, 160))
        nc = int(rng.integers(30, nr + 1))
        dens = int(rng.integers(3, 8))
        prime = int(rng.choice([3, 257, 65537, 1073741789]))
        n = int(rng.choice([1, 2, 4, 8]))
        right = bool(rng.integers(0, 2))
        if right:
            nr, nc = nc, nr
        mseed = int(rng.integers(0, 1 << 30))
        mtx = str(tmp_path / f"m{trial}.mtx")
        gen.write_random_mtx(mtx, nr, nc, dens, seed=mseed)
        ref_out = str(tmp_path / f"ref{trial}.mtx")
        cmd = [binary, "--matrix", mtx, "--prime", str(prime),
               "--n", str(n), "--output-file", ref_out]
        if right:
            cmd.append("--right")
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-500:]
        ours_out = str(tmp_path / f"ours{trial}.mtx")
        argv = [sys.executable, "-m", "block_lanczos_tpu.utils.cli",
                "--matrix", mtx, "--prime", str(prime), "--n", str(n),
                "--output-file", ours_out, "--no-checks"]
        if right:
            argv.append("--right")
        r2 = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                            timeout=600, env={**os.environ,
                                              "JAX_PLATFORMS": "cpu"})
        assert r2.returncode == 0, (
            f"seed={seed} trial={trial} p={prime} n={n} right={right} "
            f"{nr}x{nc}:\n{r2.stdout[-800:]}\n{r2.stderr[-800:]}")
        with open(ref_out, "rb") as fh:
            ref_bytes = fh.read()
        with open(ours_out, "rb") as fh:
            our_bytes = fh.read()
        assert our_bytes == ref_bytes, (
            f"DIVERGENCE seed={seed} trial={trial} p={prime} n={n} "
            f"right={right} {nr}x{nc} mseed={mseed}")
