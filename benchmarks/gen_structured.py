#!/usr/bin/env python
"""Generate the round-3 structured benchmark instance.

A 1M x 750k power-law matrix (11.3M nnz, Zipf alpha=1.2 column
popularity — relation matrices are dense in the small-prime columns) —
the structured instance class where an earlier partitioner degraded.
Used for the end-to-end CLI solve +
independent-checker benchmark row (the reference's published numbers
are on structured course matrices, not uniform random ones).

Usage: python benchmarks/gen_structured.py [--out PATH]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/blanczos_bench/skew1Mx750k.mtx")
    ap.add_argument("--nrows", type=int, default=1_000_000)
    ap.add_argument("--ncols", type=int, default=750_080)
    ap.add_argument("--density", type=int, default=14)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--alpha", type=float, default=1.2)
    args = ap.parse_args()

    from block_lanczos_tpu.utils import mmio
    from block_lanczos_tpu.utils.gen import random_sparse_skewed

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    t0 = time.time()
    i, j, x = random_sparse_skewed(args.nrows, args.ncols, args.density,
                                   seed=args.seed, alpha=args.alpha)
    odd = int(((x % 2) == 1).sum())
    print(f"gen {time.time() - t0:.0f}s nnz={len(x)} "
          f"odd(GF2 operator nnz)={odd}")
    t0 = time.time()
    mmio.write_coo_mtx(args.out, args.nrows, args.ncols, i, j, x)
    print(f"wrote {args.out} in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
