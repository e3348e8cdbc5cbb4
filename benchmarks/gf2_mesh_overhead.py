#!/usr/bin/env python
"""Attribute the GF(2) mesh overhead on a virtual CPU mesh.

Round 3 measured 2.13x s/iter going 1 -> 8 virtual devices for GF(2)
(scaling_r03_gf2_cpu8.csv) vs 1.28x for the narrow field, with no analysis.
This harness decomposes the K-device iteration into:

  local   — local work only: collectives replaced by identity (needs
            check_vma=False; results are WRONG, timing is right)
  lane    — the production pxor (L-bit lane packing, round 4)
  planes  — the round-3 pxor (32 uint8 bit-planes, 2x the volume at K<=15)

so per-iteration overhead = lane - local, the lane-vs-planes delta is the
collective-volume term, and the emulation-granularity hypothesis is
testable by scaling the matrix: if the overhead is dominated by
per-dispatch costs, its SHARE shrinks as local work grows.

A "tiny payload" variant (psum one word, broadcast to shape) was tried
and REJECTED as a latency probe: XLA folds the downstream gathers of a
broadcast value, deleting most of the next SpMV's work — it measures an
unrelated, much smaller program.

The stop probe is disabled while timing (wrong-math variants would
otherwise converge spuriously at iteration 0 and time nothing).

NOTE on absolute numbers: virtual devices share this host's cores (ONE
core as of round 4 — round 3's scaling CSVs ran with more), so K-device
runs serialize and absolute ms are not comparable across rounds; the
variant DELTAS at fixed (scale, K) and the K8/K1 ratio trend across
scales are the meaningful outputs.

Usage: python benchmarks/gf2_mesh_overhead.py --cpu 8 --iters 8
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=8,
                    help="virtual CPU device count (0 = real backend)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--nrows", type=int, default=120_000)
    ap.add_argument("--ncols", type=int, default=80_000)
    ap.add_argument("--density", type=int, default=12)
    ap.add_argument("--scales", type=int, nargs="+", default=[1, 4],
                    help="matrix size multipliers (rows and cols)")
    ap.add_argument("--meshes", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--out", default="/tmp/gf2_mesh_overhead.csv")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}").strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from block_lanczos_tpu.ops import gf2 as gf2ops
    from block_lanczos_tpu.parallel import distributed_gf2 as dg
    from block_lanczos_tpu.parallel.mesh import make_mesh
    from block_lanczos_tpu.utils.gen import random_sparse
    from block_lanczos_tpu.utils.mmio import COOMatrix
    from block_lanczos_tpu.utils.profiling import loop_s_per_iter, solver_loop

    # never stop early: wrong-math variants can hit npiv == 0 spuriously
    orig_semi = gf2ops.semi_inverse_gf2

    def semi_nostop(vtAv, n):
        winv, d, npiv = orig_semi(vtAv, n)
        return winv, d, jnp.maximum(npiv, jnp.uint32(1))

    gf2ops.semi_inverse_gf2 = semi_nostop

    def pxor_none(x, axis_name):
        return x  # timing-only; requires check_vma=False

    orig_shard_map = jax.shard_map

    def shard_map_nocheck(*a, **k):
        k["check_vma"] = False
        return orig_shard_map(*a, **k)

    variants = {
        "local": (pxor_none, shard_map_nocheck),
        "lane": (dg.pxor, orig_shard_map),
        "planes": (dg._pxor_planes, orig_shard_map),
    }

    rows = []
    for scale in args.scales:
        nr, nc = args.nrows * scale, args.ncols * scale
        i, j, x = random_sparse(nr, nc, args.density, seed=42)
        M = COOMatrix(nr, nc, len(x), i.astype(np.int32), j.astype(np.int32),
                      (x % 2).astype(np.uint32), 2)
        print(f"-- matrix {nr} x {nc}, {M.nnz} nnz, n={args.n}",
              file=sys.stderr)
        for K in args.meshes:
            mesh = make_mesh(K)
            ops = dg.partition_matrix_gf2(M, False, mesh)
            for name, (pxor_fn, sm) in variants.items():
                if K == 1 and name != "lane":
                    continue  # collectives are no-ops at K=1
                dg.pxor = pxor_fn
                jax.shard_map = sm
                try:
                    solver = dg.ShardedBlockLanczosGF2(
                        M, n=args.n, mesh=mesh, check_invariants=False,
                        ops=ops)
                    per, _ = loop_s_per_iter(*solver_loop(solver),
                                             args.iters, warmup=2)
                finally:
                    dg.pxor = variants["lane"][0]
                    jax.shard_map = orig_shard_map
                rows.append((scale, M.nnz, K, name, per))
                print(f"scale={scale} K={K} {name:>6}: "
                      f"{per * 1000:8.2f} ms/iter", file=sys.stderr)
        # attribution at the largest mesh
        d = {(k, n): p for (s, _z, k, n, p) in rows if s == scale
             for k, n, p in [(k, n, p)]}
        K = max(args.meshes)
        if (K, "local") in d:
            base, loc = d[(1, "lane")], d[(K, "local")]
            print(f"   K={K} attribution: local {loc * 1000:.2f} ms "
                  f"(K=1: {base * 1000:.2f}); collective overhead "
                  f"lane +{(d[(K, 'lane')] - loc) * 1000:.2f} / "
                  f"planes(r3) +{(d[(K, 'planes')] - loc) * 1000:.2f}; "
                  f"K{K}/K1 ratio {d[(K, 'lane')] / base:.2f}x",
                  file=sys.stderr)

    with open(args.out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["scale", "nnz", "mesh_size", "variant",
                    "s_per_iteration"])
        w.writerows(rows)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
