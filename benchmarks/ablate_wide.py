#!/usr/bin/env python
"""Wide-field iteration ablation: what makes p < 2^62 cost 4x narrow?

The wide field moves twice the narrow field's bytes per entry; this
script attributes its per-iteration cost by timing the two SpMV
applications of one iteration under controlled variants, all inside ONE
dispatch (lax.fori_loop), waiting with jax.block_until_ready:

  real       the production spmv_wide slab walk (gather + Montgomery chain
             + pair modadd per slot)
  xor        same gathers/streams, Montgomery+modadd replaced by XOR —
             the memory-side floor (what the walk would cost if the
             arithmetic were free)
  nogather   same Montgomery chain + modadd on a broadcast row — the
             compute-side floor (what the arithmetic costs if the gather
             were free)
  deferred   gather + Montgomery chain, but per-slot pair modadd replaced
             by 5x15-bit limb accumulation with ONE fold per walk
             (exact: <= 2^17 slab terms per limb; the narrow path's
             deferred-reduction idiom lifted to pairs)

Usage: python benchmarks/ablate_wide.py [--nrows 300000 --ncols 200000
       --density 15 --iters 20]
Prints one JSON line per variant.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nrows", type=int, default=300_000)
    ap.add_argument("--ncols", type=int, default=200_000)
    ap.add_argument("--density", type=int, default=15)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from block_lanczos_tpu.ops import gfp_wide as gw
    from block_lanczos_tpu.ops import wide_ops as wo
    from block_lanczos_tpu.ops.gfp import u32
    from block_lanczos_tpu.utils.gen import random_sparse
    from block_lanczos_tpu.utils.mmio import COOMatrix

    p = (1 << 61) - 1
    f = gw.GFpWide.make(p)
    i, j, x = random_sparse(args.nrows, args.ncols, args.density, seed=42)
    M = COOMatrix(args.nrows, args.ncols, len(x), i.astype(np.int32),
                  j.astype(np.int32), x.astype(np.uint64), p)
    print(f"matrix {M.nrows}x{M.ncols} nnz={M.nnz} n={args.n} p=2^61-1",
          file=sys.stderr)

    x_obj = np.asarray(M.x, dtype=object)
    first = wo.make_wide_hybrid_op(f, M.j, M.i, x_obj, M.ncols, M.nrows)
    second = wo.make_wide_hybrid_op(f, M.i, M.j, x_obj, M.nrows, M.ncols)
    n = args.n

    def walk(op, xv, product, combine):
        """Generic slab walk: product(vk, xk) per slot, combine at the end."""
        out_pad = op.cols.shape[0]
        acc = product(op.vals[:, 0][:, None, :], xv[op.cols[:, 0]], None)
        for k in range(1, op.ell):
            acc = product(op.vals[:, k][:, None, :], xv[op.cols[:, k]], acc)
        y = combine(acc, out_pad)
        if op.spill.nnz != 0:
            y = gw.modadd(f, y, wo._spmv_spill_prefix(f, op.spill, xv,
                                                      out_pad))
        return y

    def real_apply(op, xv):
        return wo.spmv_wide(f, op, xv)

    def xor_apply(op, xv):
        def product(vk, xk, acc):
            t = vk ^ xk
            return t if acc is None else acc ^ t
        return walk(op, xv, product, lambda a, _o: a)

    def nogather_apply(op, xv):
        row = jax.lax.dynamic_slice_in_dim(xv, 0, 1, 0)  # (1, n, 2)

        def product(vk, _xk, acc):
            t = gw.mont_mul(f, vk, jnp.broadcast_to(row, vk.shape[:1]
                                                    + (n, 2)))
            return t if acc is None else gw.modadd(f, acc, t)
        return walk(op, xv, product, lambda a, _o: a)

    def deferred_apply(op, xv):
        def product(vk, xk, acc):
            limbs = gw.limb_split(gw.mont_mul(f, vk, xk))
            return limbs if acc is None else acc + limbs
        return walk(op, xv, product,
                    lambda a, _o: gw.limb_combine(f, a))

    def banded_apply(op, xv):
        return wo.apply_wide(f, op, xv)

    # input banding at the wide (8 B/elem) table policy: each slab walk
    # gathers from a slice of the input (policy set before the H100 port;
    # not measured on the H100, ROADMAP C5)
    first_banded = wo.make_wide_op_auto(f, M.j, M.i, x_obj, M.ncols,
                                        M.nrows, n=n)
    second_banded = wo.make_wide_op_auto(f, M.i, M.j, x_obj, M.nrows,
                                         M.ncols, n=n)
    nb = (len(first_banded.bounds)
          if isinstance(first_banded, wo.WideBandedOp) else 1)
    print(f"banded variant: first={nb} bands", file=sys.stderr)

    variants = {"real": (first, second, real_apply),
                "xor": (first, second, xor_apply),
                "nogather": (first, second, nogather_apply),
                "deferred": (first, second, deferred_apply),
                "banded": (first_banded, second_banded, banded_apply)}
    rng = np.random.default_rng(0)
    v0 = gw.np_pair(rng.integers(0, p, (args.nrows, n),
                                 dtype=np.uint64).astype(object))
    results = {}
    for name, (first_v, second_v, apply_fn) in variants.items():
        # ops ride as pytree ARGUMENTS: closing over device arrays bakes
        # them into the program as constants, which lets XLA constant-fold
        # operator data, skewing the attribution this script measures.
        @jax.jit
        def run(first, second, v, iters):
            def one_round(_, v):
                tmp = apply_fn(first, v)
                av = apply_fn(second, tmp)
                # keep uint32 pair shape for the xor variant too
                return av
            return jax.lax.fori_loop(0, iters, one_round, v)

        v = jnp.asarray(v0)
        jax.block_until_ready(run(first_v, second_v, v, 2))  # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(run(first_v, second_v, v, args.iters))
        dt = (time.perf_counter() - t0) / args.iters
        results[name] = dt
        print(json.dumps({"variant": name, "s_per_round": round(dt, 6),
                          "ms_per_spmv_pair": round(dt * 1000, 2)}))

    base = results["real"]
    print(json.dumps({
        "summary": {k: round(v / base, 3) for k, v in results.items()},
        "memory_floor_frac": round(results["xor"] / base, 3),
        "compute_floor_frac": round(results["nogather"] / base, 3),
        "deferred_speedup": round(base / results["deferred"], 3),
        "banded_speedup": round(base / results["banded"], 3)}))


if __name__ == "__main__":
    main()
