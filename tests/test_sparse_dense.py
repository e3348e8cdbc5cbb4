"""Tests for SpMM, dense block ops, and the semi-inverse (host + device)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from block_lanczos_tpu.ops import dense, gfp, semi_inverse, spmm
from block_lanczos_tpu.ops.gfp import GFp

PRIMES = [2, 65537, 1073741789]


def rand_coo(rng, nrows, ncols, nnz, p):
    i = rng.integers(0, nrows, nnz).astype(np.int32)
    j = rng.integers(0, ncols, nnz).astype(np.int32)
    x = rng.integers(0, p, nnz, dtype=np.uint64).astype(np.uint32)
    return i, j, x


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", [1, 4])
def test_spmv_block(rng, p, n):
    f = GFp.make(p)
    nrows, ncols, nnz = 50, 37, 400
    i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
    op = spmm.make_sparse_op(f, i, j, x, nrows, ncols)
    v = rng.integers(0, p, (ncols, n), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_block(f, op, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, nrows, i, j, x, v)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1073741789])
def test_spmv_block_chunked(rng, p):
    """nnz much larger than the chunk exercises the scan accumulation."""
    f = GFp.make(p)
    nrows, ncols, n = 40, 30, 2
    nnz = 5000
    i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
    op = spmm.make_sparse_op(f, i, j, x, nrows, ncols, chunk=512)
    v = rng.integers(0, p, (ncols, n), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_block(f, op, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, nrows, i, j, x, v)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1073741789])
def test_spmv_padded_output(rng, p):
    f = GFp.make(p)
    i, j, x = rand_coo(rng, 20, 20, 100, p)
    op = spmm.make_sparse_op(f, i, j, x, 20, 20)
    v = rng.integers(0, p, (20, 3), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_block(f, op, jnp.asarray(v), out_rows=32))
    want = spmm.spmv_reference_np(p, 20, i, j, x, v)
    np.testing.assert_array_equal(got[:20], want)
    assert (got[20:] == 0).all()


def test_spmatrix_transpose(rng):
    p = 65537
    f = GFp.make(p)
    from block_lanczos_tpu.utils.mmio import COOMatrix
    i, j, x = rand_coo(rng, 25, 33, 200, p)
    M = COOMatrix(25, 33, 200, i, j, x, p)
    sp = spmm.SpMatrix.from_coo(f, M)
    v = rng.integers(0, p, (25, 2), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_block(f, sp.bwd, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, 33, j, i, x, v)  # transposed
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("shape", [(100, 4, 4), (65, 8, 3)])
def test_matmul_mod(rng, p, shape):
    f = GFp.make(p)
    N, k, m = shape
    X = rng.integers(0, p, (N, k), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, p, (k, m), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(dense.matmul_mod(f, jnp.asarray(X), jnp.asarray(B)))
    np.testing.assert_array_equal(got, gfp.np_matmul_mod(p, X, B))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("N", [10, 3000])
def test_gram_mod(rng, p, N):
    f = GFp.make(p)
    V = rng.integers(0, p, (N, 4), dtype=np.uint64).astype(np.uint32)
    W = rng.integers(0, p, (N, 5), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(dense.gram_mod(f, jnp.asarray(V), jnp.asarray(W)))
    np.testing.assert_array_equal(got, gfp.np_matmul_mod(p, V.T, W))


def test_gram_mod_chunked(rng, monkeypatch):
    p = 1073741789
    f = GFp.make(p)
    monkeypatch.setattr(dense, "_gram_chunk_rows", lambda s: 256)
    V = rng.integers(0, p, (1000, 3), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(dense.gram_mod(f, jnp.asarray(V), jnp.asarray(V)))
    np.testing.assert_array_equal(got, gfp.np_matmul_mod(p, V.T, V))


# ---------------------------------------------------------------------------
# semi-inverse
# ---------------------------------------------------------------------------

def check_semi_inverse(p, U, winv, d, npiv):
    """The defining contract: d*W == W*d == W and d == W*U*d."""
    n = U.shape[0]
    D = np.diag(d.astype(np.uint64)).astype(np.uint32)
    WU = gfp.np_matmul_mod(p, winv, U)
    WUd = gfp.np_matmul_mod(p, WU, D)
    np.testing.assert_array_equal(WUd, D)
    np.testing.assert_array_equal(gfp.np_matmul_mod(p, D, winv), winv)
    np.testing.assert_array_equal(gfp.np_matmul_mod(p, winv, D), winv)
    assert npiv == int(d.sum())


@pytest.mark.parametrize("p", [2, 3, 65537, 1073741789])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_semi_inverse_np_random(rng, p, n):
    for trial in range(8):
        # symmetric random Gram-like matrices (vtAv is symmetric)
        A = rng.integers(0, p, (n, n), dtype=np.uint64)
        U = ((A + A.T) % p).astype(np.uint32)
        winv, d, npiv = semi_inverse.semi_inverse_np(p, U)
        check_semi_inverse(p, U, winv, d, npiv)


@pytest.mark.parametrize("p", [65537, 1073741789])
@pytest.mark.parametrize("n", [4])
def test_semi_inverse_np_singular(rng, p, n):
    # rank-1 symmetric matrix: must find < n pivots and still satisfy contract
    a = rng.integers(0, p, (n, 1), dtype=np.uint64)
    U = ((a @ a.T) % p).astype(np.uint32)
    winv, d, npiv = semi_inverse.semi_inverse_np(p, U)
    assert 0 < npiv < n
    check_semi_inverse(p, U, winv, d, npiv)
    # zero matrix: 0 pivots (the Lanczos stop condition)
    winv, d, npiv = semi_inverse.semi_inverse_np(p, np.zeros((n, n), np.uint32))
    assert npiv == 0 and (d == 0).all()


@pytest.mark.parametrize("p", [2, 3, 65537, 1073741789])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_semi_inverse_device_matches_np(rng, p, n):
    f = GFp.make(p)
    dev = jax.jit(lambda U: semi_inverse.semi_inverse_device(f, U))
    for trial in range(6):
        A = rng.integers(0, p, (n, n), dtype=np.uint64)
        U = ((A + A.T) % p).astype(np.uint32)
        if trial == 0:
            U = np.zeros_like(U)
        if trial == 1:
            a = rng.integers(0, p, (n, 1), dtype=np.uint64)
            U = ((a @ a.T) % p).astype(np.uint32)
        w_np, d_np, npiv_np = semi_inverse.semi_inverse_np(p, U)
        w_d, d_d, npiv_d = dev(jnp.asarray(U))
        np.testing.assert_array_equal(np.asarray(w_d), w_np)
        np.testing.assert_array_equal(np.asarray(d_d), d_np)
        assert int(npiv_d) == npiv_np


@pytest.mark.parametrize("p", [1073741789])
def test_spmv_scan_fallback_matches_prefix(rng, p):
    """Force the chunked-scan fallback and compare with the prefix path."""
    f = GFp.make(p)
    nrows, ncols, n, nnz = 60, 45, 3, 3000
    i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
    op = spmm.make_sparse_op(f, i, j, x, nrows, ncols, chunk=256)
    v = rng.integers(0, p, (ncols, n), dtype=np.uint64).astype(np.uint32)
    fast = np.asarray(spmm.spmv_block(f, op, jnp.asarray(v)))
    import dataclasses
    op_slow = dataclasses.replace(op, seg_safe=False)
    slow = np.asarray(spmm.spmv_block(f, op_slow, jnp.asarray(v)))
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(
        fast, spmm.spmv_reference_np(p, nrows, i, j, x, v))


def test_spmv_empty_rows_and_cols(rng):
    """Rows/cols with no entries and an empty matrix behave like zeros."""
    p = 65537
    f = GFp.make(p)
    i = np.array([2, 2, 7], np.int32)
    j = np.array([1, 3, 0], np.int32)
    x = np.array([5, 6, 7], np.uint32)
    op = spmm.make_sparse_op(f, i, j, x, 10, 5)
    v = rng.integers(0, p, (5, 2), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_block(f, op, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, 10, i, j, x, v)
    np.testing.assert_array_equal(got, want)
    # fully empty operator
    op0 = spmm.make_sparse_op(f, np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.uint32), 4, 5)
    got0 = np.asarray(spmm.spmv_block(f, op0, jnp.asarray(v[:5])))
    assert (got0 == 0).all()


@pytest.mark.parametrize("p", [2, 65537, 1073741789])
@pytest.mark.parametrize("n", [1, 4])
def test_spmv_hybrid(rng, p, n):
    f = GFp.make(p)
    nrows, ncols, nnz = 50, 37, 500
    i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols)
    v = rng.integers(0, p, (ncols, n), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, nrows, i, j, x, v)
    np.testing.assert_array_equal(got, want)


def test_spmv_hybrid_skewed_spill(rng):
    """One dense row forces spill entries; slab stays near the mean width."""
    p = 1073741789
    f = GFp.make(p)
    nrows, ncols = 64, 200
    # sparse background + one dense row
    i, j, x = rand_coo(rng, nrows, ncols, 300, p)
    dense_j = np.arange(ncols, dtype=np.int32)
    i = np.concatenate([i, np.full(ncols, 7, np.int32)])
    j = np.concatenate([j, dense_j])
    x = np.concatenate([x, rng.integers(1, p, ncols, dtype=np.uint64)
                        .astype(np.uint32)])
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols)
    assert op.ell < ncols          # slab did NOT blow up to the dense row
    assert op.spill.nnz > 0        # the dense row spilled
    v = rng.integers(0, p, (ncols, 3), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, nrows, i, j, x, v)
    np.testing.assert_array_equal(got, want)


def test_spmv_hybrid_wide_slab_fori(rng):
    """ell > unroll limit exercises the fori_loop slab walk."""
    p = 65537
    f = GFp.make(p)
    nrows, ncols = 8, 128
    i = np.repeat(np.arange(nrows, dtype=np.int32), 100)
    j = np.tile(np.arange(100, dtype=np.int32), nrows)
    x = rng.integers(1, p, nrows * 100, dtype=np.uint64).astype(np.uint32)
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols, ell=100)
    assert op.ell > spmm._ELL_UNROLL
    v = rng.integers(0, p, (ncols, 2), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    want = spmm.spmv_reference_np(p, nrows, i, j, x, v)
    np.testing.assert_array_equal(got, want)


def test_spmv_hybrid_out_pad(rng):
    p = 65537
    f = GFp.make(p)
    i, j, x = rand_coo(rng, 20, 20, 100, p)
    op = spmm.make_hybrid_op(f, i, j, x, 20, 20, out_pad=24)
    v = rng.integers(0, p, (20, 3), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v), out_rows=32))
    want = spmm.spmv_reference_np(p, 20, i, j, x, v)
    np.testing.assert_array_equal(got[:20], want)
    assert (got[20:] == 0).all()


def test_delta_encoding_adopted_and_exact(rng):
    """Typical random matrix: the u16-delta slab is adopted (cols is None)
    and results stay bit-exact vs the oracle."""
    p = 1073741789
    f = GFp.make(p)
    nrows, ncols, nnz = 80, 120, 900
    i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols)
    assert op.dcols is not None and op.cols is None
    assert op.dcols.dtype == jnp.uint16
    v = rng.integers(0, p, (ncols, 4), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    np.testing.assert_array_equal(got, spmm.spmv_reference_np(p, nrows, i, j, x, v))
    # and the absolute layout gives the identical result
    op_abs = spmm.make_hybrid_op(f, i, j, x, nrows, ncols, delta=False)
    assert op_abs.cols is not None
    got_abs = np.asarray(spmm.spmv_hybrid(f, op_abs, jnp.asarray(v)))
    np.testing.assert_array_equal(got, got_abs)


def test_delta_encoding_eviction(rng):
    """Rows with a few >= 2^16 column gaps: the oversized-gap entries are
    evicted to the spill sidecar and the product stays exact."""
    p = 65537
    f = GFp.make(p)
    nrows, ncols = 16, 1 << 18
    # each row: a tight cluster plus one far column (gap >> 2^16)
    i = np.repeat(np.arange(nrows, dtype=np.int32), 5)
    j_cluster = rng.integers(0, 1000, (nrows, 4)).astype(np.int32)
    j_far = rng.integers(1 << 17, ncols, (nrows, 1)).astype(np.int32)
    j = np.concatenate([j_cluster, j_far], axis=1).ravel()
    x = rng.integers(1, p, nrows * 5, dtype=np.uint64).astype(np.uint32)
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols)
    if op.dcols is not None:  # adopted (16 evictions <= max(64, ...))
        assert op.spill.nnz >= nrows  # far entries went to the spill
    v = rng.integers(0, p, (ncols, 2), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    np.testing.assert_array_equal(
        got, spmm.spmv_reference_np(p, nrows, i, j, x, v))


def test_delta_encoding_fallback(rng):
    """Adversarial matrix (every gap oversized, many entries): the builder
    falls back to the absolute slab rather than spilling everything."""
    p = 65537
    f = GFp.make(p)
    nrows, width = 200, 40
    ncols = width * (1 << 17)
    # every row hits columns k * 2^17: every within-row gap is 2^17
    i = np.repeat(np.arange(nrows, dtype=np.int32), width)
    j = np.tile((np.arange(width, dtype=np.int64) << 17).astype(np.int32),
                nrows)
    x = rng.integers(1, p, nrows * width, dtype=np.uint64).astype(np.uint32)
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols, ell=width)
    assert op.cols is not None and op.dcols is None  # fell back
    v = rng.integers(0, p, (ncols, 1), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    np.testing.assert_array_equal(
        got, spmm.spmv_reference_np(p, nrows, i, j, x, v))


def test_delta_encoding_fori_loop(rng):
    """Delta decode through the ell > unroll-limit fori_loop path."""
    p = 65537
    f = GFp.make(p)
    nrows, ncols = 8, 4096
    per = 100
    i = np.repeat(np.arange(nrows, dtype=np.int32), per)
    j = np.tile(np.sort(rng.choice(ncols, per, replace=False)).astype(np.int32),
                nrows)
    x = rng.integers(1, p, nrows * per, dtype=np.uint64).astype(np.uint32)
    op = spmm.make_hybrid_op(f, i, j, x, nrows, ncols, ell=per)
    assert op.ell > spmm._ELL_UNROLL and op.dcols is not None
    v = rng.integers(0, p, (ncols, 2), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.spmv_hybrid(f, op, jnp.asarray(v)))
    np.testing.assert_array_equal(
        got, spmm.spmv_reference_np(p, nrows, i, j, x, v))


def test_banded_op_matches_monolithic(rng):
    """Input banding is bit-exact vs the monolithic hybrid op and works as
    a jit argument (pytree round-trip)."""
    import jax
    p = 1073741789
    f = GFp.make(p)
    nrows, ncols, nnz = 60, 101, 700  # in_dim not divisible by the bands
    i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
    mono = spmm.make_hybrid_op(f, i, j, x, nrows, ncols)
    band = spmm.make_banded_op(f, i, j, x, nrows, ncols, nbands=3)
    assert len(band.parts) == 3
    assert band.bounds[-1][1] == ncols
    v = rng.integers(0, p, (ncols, 4), dtype=np.uint64).astype(np.uint32)
    got_m = np.asarray(spmm.apply_op(f, mono, jnp.asarray(v)))
    ap = jax.jit(lambda op, x: spmm.apply_op(f, op, x))
    got_b = np.asarray(ap(band, jnp.asarray(v)))
    np.testing.assert_array_equal(got_m, got_b)
    np.testing.assert_array_equal(got_b, spmm.spmv_reference_np(p, nrows, i, j, x, v))


def test_banded_op_empty_band(rng):
    """A band with zero entries still contributes zeros (no crash)."""
    p = 65537
    f = GFp.make(p)
    nrows, ncols = 20, 96
    # all entries in the FIRST third of the columns
    i = rng.integers(0, nrows, 150).astype(np.int32)
    j = rng.integers(0, 32, 150).astype(np.int32)
    x = rng.integers(1, p, 150, dtype=np.uint64).astype(np.uint32)
    band = spmm.make_banded_op(f, i, j, x, nrows, ncols, nbands=3)
    v = rng.integers(0, p, (ncols, 2), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(spmm.apply_op(f, band, jnp.asarray(v)))
    np.testing.assert_array_equal(
        got, spmm.spmv_reference_np(p, nrows, i, j, x, v))


def test_band_count_policy():
    """Measured policy: band only 3.2-10 MB tables at small n, 3-6 bands."""
    assert spmm.band_count(300_000, 4) == 3     # 4.8 MB -> 3 bands
    assert spmm.band_count(200_000, 4) == 1     # 3.2 MB fits
    assert spmm.band_count(200_000, 32) == 1    # thin-band regime: off
    assert spmm.band_count(3_000_000, 4) == 1   # 48 MB: many-band regime, off
    assert spmm.band_count(600_000, 4) == 6     # 9.6 MB -> 6 bands
    assert spmm.band_count(50_000, 1) == 1


def test_layout_fuzz_all_equal(rng):
    """Random matrices: every layout (coo, hybrid-absolute, hybrid-delta,
    banded x {absolute, delta}) produces the identical product."""
    import jax
    p = 1073741789
    f = GFp.make(p)
    for trial in range(6):
        nrows = int(rng.integers(20, 150))
        ncols = int(rng.integers(20, 150))
        nnz = int(rng.integers(10, 4 * max(nrows, ncols)))
        n = int(rng.choice([1, 3, 4]))
        i, j, x = rand_coo(rng, nrows, ncols, nnz, p)
        v = rng.integers(0, p, (ncols, n), dtype=np.uint64).astype(np.uint32)
        want = spmm.spmv_reference_np(p, nrows, i, j, x, v)
        ops = [
            spmm.make_sparse_op(f, i, j, x, nrows, ncols),
            spmm.make_hybrid_op(f, i, j, x, nrows, ncols, delta=False),
            spmm.make_hybrid_op(f, i, j, x, nrows, ncols, delta=True),
            spmm.make_banded_op(f, i, j, x, nrows, ncols, nbands=3,
                                delta=False),
            spmm.make_banded_op(f, i, j, x, nrows, ncols, nbands=4,
                                delta=True),
        ]
        for op in ops:
            got = np.asarray(spmm.apply_op(f, op, jnp.asarray(v)))
            np.testing.assert_array_equal(
                got[:nrows], want,
                err_msg=f"trial={trial} layout={type(op).__name__}")
