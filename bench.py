#!/usr/bin/env python
"""Benchmark: block-Lanczos iteration time on one GPU vs the C reference.

Measures the steady-state per-iteration time of the full solver (2 exact
mod-p SpMVs + 2 Gram products + semi-inverse + orthogonalize) on a
generated sparse matrix with the reference's benchmark configuration
(--prime 1073741789 --n 4; BASELINE.md), plus the production blockings,
the bitsliced GF(2) and wide fields, and a 51M-nnz GF(2) matrix.

Prints ONE JSON line:
  {"metric": "spmv_nnz_per_s_per_chip", "value": ..., "unit": "nnz/s",
   "vs_baseline": <our iterations/s divided by sequential C iterations/s>,
   "device": {...}, "detail": {...}}

Exits nonzero, printing no result, when JAX finds no GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np

PRIME = 1073741789
N_BLOCK = 4
NROWS, NCOLS, DENSITY, SEED = 300_000, 200_000, 15, 42
WARMUP_ITERS = 4
BENCH_ITERS = 40

# Sequential C reference, s/iteration on the bench matrix (300k x 200k,
# 15/row, seed 42): CPU timings of the reference's own binary on one core
# of the development host (min of runs), kept as constants because the
# reference sources are not part of this repository.
REF_C_CPU_S_PER_ITER = {
    ("narrow", 4): 0.2223117533000732,
    ("narrow", 32): 6.990915220750139,
    ("gf2", 128): 143.10986694300027,
}


def bench_matrix(prime, nrows=NROWS, ncols=NCOLS, density=DENSITY):
    from block_lanczos_tpu.utils.gen import random_coo
    return random_coo(nrows, ncols, density, prime, seed=SEED)


def per_iter(solver, iters=BENCH_ITERS):
    """Steady s/iteration of the solver's own device loop."""
    from block_lanczos_tpu.utils.profiling import loop_s_per_iter, solver_loop
    return loop_s_per_iter(*solver_loop(solver), iters, WARMUP_ITERS)[0]


def device_stamp():
    import jax
    dev = jax.devices()[0]
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        power = None
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": power}


def main() -> int:
    import jax

    from block_lanczos_tpu.models.lanczos import BlockLanczos
    from block_lanczos_tpu.models.lanczos_gf2 import BlockLanczosGF2
    from block_lanczos_tpu.models.lanczos_wide import BlockLanczosWide
    from block_lanczos_tpu.parallel.distributed_gf2 import (
        ShardedBlockLanczosGF2, partition_matrix_gf2)
    from block_lanczos_tpu.parallel.mesh import make_mesh
    from block_lanczos_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    M = bench_matrix(PRIME)
    d = {"nnz": M.nnz, "n": N_BLOCK, "prime": PRIME}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"[stage] {name}: done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        return out

    # headline at the reference's benchmark config (n=4)
    ours = stage("narrow n=4", lambda: per_iter(
        BlockLanczos(M, n=N_BLOCK, check_invariants=False)))
    d["our_s_per_iteration"] = ours
    d["iterations_per_s"] = 1.0 / ours
    # production blocking (fewer iterations per solve)
    ours_n32 = stage("narrow n=32", lambda: per_iter(
        BlockLanczos(M, n=32, check_invariants=False)))
    d["n32_s_per_iteration"] = ours_n32

    M2 = bench_matrix(2)
    for n in (128, 256):
        d[f"gf2_n{n}_s_per_iteration"] = stage(
            f"gf2 n={n}", lambda: per_iter(
                BlockLanczosGF2(M2, n=n, check_invariants=False)))
    Mw = bench_matrix((1 << 61) - 1)
    d["wide_p61_s_per_iteration"] = stage(
        "wide p61 n=4", lambda: per_iter(
            BlockLanczosWide(Mw, n=N_BLOCK, check_invariants=False),
            BENCH_ITERS // 2))
    del M2, Mw

    # 51M-nnz factorization scale (3M x 2M mod 2) through the 1x1-mesh
    # program the CLI picks at this size; the partition is independent of
    # the blocking n, so it is built once
    M51 = bench_matrix(2, 3_000_000, 2_000_000, 17)
    mesh = make_mesh(1)
    ops = stage("gf2 51M build", lambda: partition_matrix_gf2(
        M51, False, mesh))
    for n in (128, 256):
        d[f"gf2_51m_n{n}_s_per_iteration"] = stage(
            f"gf2 51M n={n}", lambda: per_iter(
                ShardedBlockLanczosGF2(M51, n=n, mesh=mesh,
                                       check_invariants=False, ops=ops),
                8))

    # the C reference's CPU timings at equal n: iterations scale as
    # ncols/n on both sides, so the per-iteration ratio is the
    # time-to-solution ratio
    ref = REF_C_CPU_S_PER_ITER
    d["reference_c_cpu_s_per_iteration"] = {
        f"{field}_n{n}": v for (field, n), v in ref.items()}
    d["n32_vs_baseline"] = ref[("narrow", 32)] / ours_n32
    d["gf2_n128_vs_baseline"] = (ref[("gf2", 128)]
                                 / d["gf2_n128_s_per_iteration"])
    print(json.dumps({
        "metric": "spmv_nnz_per_s_per_chip",
        "value": 2 * M.nnz / ours, "unit": "nnz/s",  # 2 SpMVs/iteration
        "vs_baseline": ref[("narrow", N_BLOCK)] / ours,
        "device": device_stamp(), "detail": d}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
