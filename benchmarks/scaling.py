#!/usr/bin/env python
"""Scaling benchmark: per-iteration time and nnz/s vs mesh size.

The reference's benchmark suite measures wall time of the MPI/OpenMP/hybrid
variants over core/node counts (reference: benchmarks/times.txt,
mpi_vs_openMP.csv).  The analogue here is solver throughput over mesh sizes.
On several GPUs this measures scaling over NVLink; on a CPU host it
validates the scaling *machinery* via the virtual device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N).

Writes a CSV (mesh_size, s_per_iteration, nnz_per_s, efficiency) and prints
a table.  Usage:
    python benchmarks/scaling.py [--cpu N] [--nrows R --ncols C --density D]
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="force CPU platform with N virtual devices")
    ap.add_argument("--nrows", type=int, default=120_000)
    ap.add_argument("--ncols", type=int, default=80_000)
    ap.add_argument("--density", type=int, default=12)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--prime", type=int, default=1073741789)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--overlap", action="store_true",
                    help="comm/compute overlap mode (all three fields)")
    ap.add_argument("--skewed", action="store_true",
                    help="power-law row weights (factorization-shaped "
                         "instance) instead of uniform")
    ap.add_argument("--out", default="/tmp/blanczos_scaling.csv")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}").strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from block_lanczos_tpu.ops.gfp import PRIME_CAP
    from block_lanczos_tpu.utils.gen import random_sparse, \
        random_sparse_skewed
    from block_lanczos_tpu.utils.mmio import COOMatrix
    from block_lanczos_tpu.parallel import make_mesh
    from block_lanczos_tpu.parallel.distributed import ShardedBlockLanczos
    from block_lanczos_tpu.utils.profiling import loop_s_per_iter, solver_loop

    if args.skewed:
        # Zipf ROW weights: generate with skewed columns, then transpose —
        # the kernel dimension carries the skew, the shape the balanced
        # partition (parallel/sharding.balanced_band_map) exists for
        j, i, x = random_sparse_skewed(args.ncols, args.nrows,
                                       args.density, seed=42)
        order = np.lexsort((j, i))
        i, j, x = i[order], j[order], x[order]
    else:
        i, j, x = random_sparse(args.nrows, args.ncols, args.density,
                                seed=42)
    # field selection matches the CLI: p=2 (n%32==0) -> bitsliced GF(2);
    # p > 2^30-35 -> wide pairs; otherwise narrow
    if args.prime == 2 and args.n % 32 == 0:
        from block_lanczos_tpu.parallel.distributed_gf2 import \
            ShardedBlockLanczosGF2 as Solver
        xv = (x % 2).astype(np.uint32)
    elif args.prime > PRIME_CAP:
        from block_lanczos_tpu.parallel.distributed_wide import \
            ShardedBlockLanczosWide as Solver
        xv = (x % args.prime).astype(np.uint64)
    else:
        Solver = ShardedBlockLanczos
        xv = (x % args.prime).astype(np.uint32)
    M = COOMatrix(args.nrows, args.ncols, len(xv), i.astype(np.int32),
                  j.astype(np.int32), xv, args.prime)
    print(f"matrix: {M.nrows} x {M.ncols}, {M.nnz} nnz; n={args.n}, "
          f"p={args.prime} [{Solver.__name__}]", file=sys.stderr)

    n_avail = len(jax.devices())
    sizes = [k for k in (1, 2, 4, 8, 16, 32) if k <= n_avail]
    rows = []
    base = None
    for k in sizes:
        solver = Solver(M, n=args.n, mesh=make_mesh(k),
                        check_invariants=False, overlap=args.overlap)
        # compile + warm, then time the device loop to completion
        per_iter, _ = loop_s_per_iter(*solver_loop(solver), args.iters,
                                      warmup=2)
        nnz_s = 2 * M.nnz / per_iter
        if base is None:
            base = per_iter
        eff = base / (per_iter * k)
        st = solver.ops.stats
        nnz_arr = st.shard_nnz.astype(float)
        imb = float(nnz_arr.max() / max(nnz_arr.mean(), 1.0))
        slots = st.total_slab_slots + st.total_spill_slots
        rows.append((k, per_iter, nnz_s, eff, imb, slots,
                     int(st.row_balanced or st.col_balanced)))
        print(f"mesh={k:3d}  {per_iter*1000:9.2f} ms/iter  "
              f"{nnz_s/1e6:9.1f} Mnnz/s  efficiency={eff:6.1%}  "
              f"shard-imb={imb:4.2f}x  slots={slots}")

    with open(args.out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["mesh_size", "s_per_iteration", "nnz_per_s",
                    "efficiency", "max_shard_nnz_over_mean", "total_slots",
                    "balanced_layout"])
        w.writerows(rows)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
