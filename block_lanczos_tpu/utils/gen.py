"""Random sparse test-matrix generation.

The reference downloads course matrices (project.py) or SuiteSparse files;
those servers are unreachable here, so this module generates structurally
similar matrices: random sparse integer general MatrixMarket files.  A left
kernel (x*M == 0) is guaranteed nontrivial whenever nrows > ncols, which is
how the tests arrange a solvable instance.
"""

from __future__ import annotations

import numpy as np

from block_lanczos_tpu.utils import mmio


def random_sparse(nrows: int, ncols: int, row_density: int, seed: int = 0,
                  max_value: int = 1 << 20):
    """Random COO with ~row_density entries per row, unique (i, j) pairs."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(nrows, dtype=np.int64), row_density)
    j = rng.integers(0, ncols, size=len(i), dtype=np.int64)
    key = i * ncols + j
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    i, j = i[idx], j[idx]
    x = rng.integers(1, max_value, size=len(i), dtype=np.int64)
    return i, j, x


def random_coo(nrows: int, ncols: int, row_density: int, prime: int,
               seed: int = 0) -> mmio.COOMatrix:
    """random_sparse as a COOMatrix over GF(prime), built in memory (no
    MatrixMarket round trip); coefficients are uint64 above the narrow
    field's bound, uint32 below it."""
    i, j, x = random_sparse(nrows, ncols, row_density, seed)
    dtype = np.uint64 if prime > 0x3FFFFFDD else np.uint32
    return mmio.COOMatrix(nrows, ncols, len(x), i.astype(np.int32),
                          j.astype(np.int32), (x % prime).astype(dtype),
                          prime)


def write_random_mtx(path: str, nrows: int, ncols: int, row_density: int,
                     seed: int = 0, max_value: int = 1 << 20):
    i, j, x = random_sparse(nrows, ncols, row_density, seed, max_value)
    mmio.write_coo_mtx(path, nrows, ncols, i, j, x)
    return len(x)


def random_sparse_skewed(nrows: int, ncols: int, row_density: int,
                         seed: int = 0, alpha: float = 1.2,
                         max_value: int = 1 << 20):
    """Random COO with power-law (Zipf-like) column popularity.

    Matrices from integer factorization / discrete log have heavily skewed
    column weights (a few dense "small prime" columns, a long sparse tail);
    this generator reproduces that shape to exercise the hybrid layout's
    spill path (ops/spmm.py).
    """
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(nrows, dtype=np.int64), row_density)
    # inverse-CDF sample of a truncated zipf over column ranks
    ranks = np.arange(1, ncols + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w) / w.sum()
    j = np.searchsorted(cdf, rng.random(len(i))).astype(np.int64)
    j = np.minimum(j, ncols - 1)
    key = i * ncols + j
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    i, j = i[idx], j[idx]
    x = rng.integers(1, max_value, size=len(i), dtype=np.int64)
    return i, j, x
