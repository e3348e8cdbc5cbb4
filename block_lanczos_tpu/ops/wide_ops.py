"""Dense + sparse mod-p kernels for WIDE primes (p < 2^62).

Mirrors ops/dense.py, ops/spmm.py and ops/semi_inverse.py on the
uint32-pair representation of ops/gfp_wide.py.  Layouts and algorithms are
identical to the narrow field (hybrid ELL+spill SpMV, chunked exact Gram,
masked on-device Gauss-Jordan) so the solver drivers stay line-parallel;
only the scalar arithmetic widens.  Reference parity citations live in the
narrow modules.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.ops import gfp
from block_lanczos_tpu.ops import gfp_wide as gw
from block_lanczos_tpu.ops.gfp import u32
from block_lanczos_tpu.ops.gfp_wide import GFpWide, N_LIMBS

DEFAULT_CHUNK = 1 << 17


# ---------------------------------------------------------------------------
# Dense block linear algebra
# ---------------------------------------------------------------------------

def matmul_mont(f: GFpWide, X, Bm):
    """(N, k, 2) @ (k, m, 2) mod p, Bm Montgomery-form; k, m block-sized."""
    prod = gw.mont_mul(f, X[:, :, None, :], Bm[None, :, :, :])  # (N,k,m,2)
    limbs = gw.limb_split(prod)                                  # (N,k,m,5)
    return gw.limb_combine(f, jnp.sum(limbs, axis=1))            # (N,m,2)


def matmul_mod(f: GFpWide, X, B):
    return matmul_mont(f, X, gw.to_mont(f, B))


def _gram_chunk_rows(n_cols_sq: int) -> int:
    budget = max(128, (1 << 22) // max(n_cols_sq * N_LIMBS, 1))
    return min(gw.LIMB_SUM_MAX, budget)


def gram_mod(f: GFpWide, V, W):
    """V^T @ W mod p for (N, a, 2) and (N, b, 2); exact, any N."""
    N, a = V.shape[0], V.shape[1]
    b = W.shape[1]
    chunk = _gram_chunk_rows(a * b)
    Wm = gw.to_mont(f, W)

    def chunk_gram(Vc, Wc):
        prod = gw.mont_mul(f, Vc[:, :, None, :], Wc[:, None, :, :])
        limbs = gw.limb_split(prod)            # (c, a, b, 5)
        return gw.limb_combine(f, jnp.sum(limbs, axis=0))

    if N <= chunk:
        return chunk_gram(V, Wm)
    pad = (-N) % chunk
    if pad:
        V = jnp.pad(V, ((0, pad), (0, 0), (0, 0)))
        Wm = jnp.pad(Wm, ((0, pad), (0, 0), (0, 0)))
    nchunks = (N + pad) // chunk

    def body(acc, vw):
        Vc, Wc = vw
        return gw.modadd(f, acc, chunk_gram(Vc, Wc)), None

    acc0 = gfp.zeros_vma_like((V, Wm), (a, b, 2))  # joined vma carry
    acc, _ = jax.lax.scan(
        body, acc0,
        (V.reshape(nchunks, chunk, a, 2), Wm.reshape(nchunks, chunk, b, 2)))
    return acc


# ---------------------------------------------------------------------------
# Semi-inverse (two-phase masked Gauss-Jordan), wide
# ---------------------------------------------------------------------------

def _is_zero(x):
    return (x[..., 0] == 0) & (x[..., 1] == 0)


def _eliminate_device(f: GFpWide, M, W):
    """Masked sweep on (n, n, 2) pair matrices; returns (M, W, d, npiv)."""
    n = M.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]

    def body(j, state):
        M, W, d, npiv = state
        col = jax.lax.dynamic_index_in_dim(M, j, 1, keepdims=False)  # (n, 2)
        cand = (~_is_zero(col)) & (rows >= j)
        found = jnp.any(cand)
        pivot = jnp.argmax(cand).astype(jnp.int32)

        pivot_val = jax.lax.dynamic_index_in_dim(col, pivot, 0, keepdims=False)
        safe = jnp.where(_is_zero(pivot_val),
                         gw.pair(jnp.ones((), u32), jnp.zeros((), u32)),
                         pivot_val)
        pinv_m = gw.to_mont(f, gw.modinv_device(f, safe))

        perm = jnp.where(rows == j, pivot, jnp.where(rows == pivot, j, rows))
        M2 = M[perm]
        W2 = W[perm]
        rowj_M = gw.mont_mul(f, M2[j], pinv_m[None, :])
        rowj_W = gw.mont_mul(f, W2[j], pinv_m[None, :])
        M2 = jax.lax.dynamic_update_index_in_dim(M2, rowj_M, j, 0)
        W2 = jax.lax.dynamic_update_index_in_dim(W2, rowj_W, j, 0)
        colj = jax.lax.dynamic_index_in_dim(M2, j, 1, keepdims=False)
        mult = gw.modneg(f, colj)                      # (n, 2)
        is_j = (rows == j)[:, None, None]
        M3 = jnp.where(is_j, M2, gw.modadd(
            f, M2, gw.mont_mul(f, mult[:, None, :],
                               gw.to_mont(f, rowj_M)[None, :, :])))
        W3 = jnp.where(is_j, W2, gw.modadd(
            f, W2, gw.mont_mul(f, mult[:, None, :],
                               gw.to_mont(f, rowj_W)[None, :, :])))

        M = jnp.where(found, M3, M)
        W = jnp.where(found, W3, W)
        d = d.at[j].set(found.astype(u32))
        npiv = npiv + found.astype(jnp.int32)
        return M, W, d, npiv

    d0 = jnp.zeros(n, u32)
    return jax.lax.fori_loop(0, n, body, (M, W, d0, jnp.int32(0)))


def semi_inverse_device(f: GFpWide, U):
    """(winv, d, npiv) for an (n, n, 2) pair matrix; jit-safe."""
    n = U.shape[0]
    scratch = jnp.zeros_like(U)
    _, _, d1, _ = _eliminate_device(f, U, scratch)
    mask = ((d1[:, None] * d1[None, :]) != 0)[..., None]
    M2 = jnp.where(mask, U, u32(0))
    eye = jnp.eye(n, dtype=u32) * d1[None, :]
    W0 = jnp.stack([eye, jnp.zeros_like(eye)], axis=-1)
    _, W, d, npiv = _eliminate_device(f, M2, W0)
    return W, d, npiv


def semi_inverse_py(p: int, U_obj: np.ndarray):
    """Host oracle on object-int matrices (same two-phase semantics)."""
    n = U_obj.shape[0]

    def eliminate(M, W):
        d = np.zeros(n, np.uint32)
        npiv = 0
        for j in range(n):
            nz = [i for i in range(j, n) if M[i, j] % p != 0]
            if not nz:
                continue
            pivot = nz[0]
            d[j] = 1
            npiv += 1
            pinv = pow(int(M[pivot, j]), p - 2, p)
            M[pivot] = (M[pivot] * pinv) % p
            M[[j, pivot]] = M[[pivot, j]]
            if W is not None:
                W[pivot] = (W[pivot] * pinv) % p
                W[[j, pivot]] = W[[pivot, j]]
            mult = (p - M[:, j]) % p
            mult[j] = 0
            M[:] = (M + mult[:, None] * M[j][None, :]) % p
            if W is not None:
                W[:] = (W + mult[:, None] * W[j][None, :]) % p
        return d, npiv

    M = U_obj.astype(object) % p
    d1, _ = eliminate(M, None)
    mask = (d1[:, None] & d1[None, :]).astype(bool)
    M2 = np.where(mask, U_obj % p, 0).astype(object)
    W = (np.eye(n, dtype=np.uint32) * d1).astype(object)
    d, npiv = eliminate(M2, W)
    return W, d, npiv


# ---------------------------------------------------------------------------
# Sparse ops (hybrid ELL + spill), wide values
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class WideSparseOp:
    """COO direction sorted by out row; val_mont (nnzp, 2) Montgomery pairs."""
    out_dim: int
    in_dim: int
    nnz: int
    out_idx: jax.Array
    in_idx: jax.Array
    val_mont: jax.Array
    rowptr: jax.Array

    def tree_flatten(self):
        return ((self.out_idx, self.in_idx, self.val_mont, self.rowptr),
                (self.out_dim, self.in_dim, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        out_idx, in_idx, val_mont, rowptr = children
        return cls(*aux, out_idx, in_idx, val_mont, rowptr)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class WideHybridOp:
    out_dim: int
    in_dim: int
    nnz: int
    ell: int
    cols: jax.Array     # (out_pad, L) int32
    vals: jax.Array     # (out_pad, L, 2) Montgomery pairs
    spill: WideSparseOp

    def tree_flatten(self):
        return ((self.cols, self.vals, self.spill),
                (self.out_dim, self.in_dim, self.nnz, self.ell))

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals, spill = children
        return cls(*aux, *children)


def _to_mont_pairs(f: GFpWide, vals_obj):
    """object ints -> (..., 2) uint32 Montgomery pairs."""
    vm = np.asarray(vals_obj, dtype=object)
    vm = (vm % f.p) * (1 << 64) % f.p
    return gw.np_pair(vm)


def build_wide_hybrid_arrays(f: GFpWide, out_idx, in_idx, vals, out_dim: int,
                             ell: int | None = None,
                             spill_pad_to: int | None = None):
    """Host-side wide ELL slab + spill construction (NumPy arrays).

    Returns (cols2d, vals2d, (s_out, s_in, s_vm, s_nnz, rowptr), nnz, ell).
    """
    from block_lanczos_tpu.ops.spmm import choose_ell_width

    out_idx = np.asarray(out_idx, np.int64)
    in_idx = np.asarray(in_idx, np.int64)
    vals = np.asarray(vals, dtype=object)
    order = np.lexsort((in_idx, out_idx))
    out_idx, in_idx, vals = out_idx[order], in_idx[order], vals[order]
    nnz = len(vals)
    counts = (np.bincount(out_idx, minlength=out_dim) if nnz
              else np.zeros(out_dim, np.int64))
    if ell is None:
        ell = choose_ell_width(counts)
    # keep every spill segment under the 2^17 limb-sum cap (prefix trick)
    if counts.size and int(counts.max()) - int(ell) > gw.LIMB_SUM_MAX:
        ell = int(counts.max()) - gw.LIMB_SUM_MAX
    from block_lanczos_tpu.ops.spmm import _within_row_positions
    pos = _within_row_positions(out_idx)
    vm = _to_mont_pairs(f, vals)             # (nnz, 2)

    in_slab = pos < ell
    flat = (out_idx * ell + pos)[in_slab]
    cols2d = np.zeros(out_dim * ell, np.int32)
    vals2d = np.zeros((out_dim * ell, 2), np.uint32)
    cols2d[flat] = in_idx[in_slab]
    vals2d[flat] = vm[in_slab]
    cols2d = cols2d.reshape(out_dim, ell)
    vals2d = vals2d.reshape(out_dim, ell, 2)

    sp = ~in_slab
    s_out = out_idx[sp].astype(np.int32)
    s_in = in_idx[sp].astype(np.int32)
    s_vm = vm[sp]
    s_nnz = len(s_out)
    rowptr = np.searchsorted(s_out, np.arange(out_dim + 1)).astype(np.int32)
    target = max(s_nnz, spill_pad_to or 0, 1)
    pad = target - s_nnz
    if pad:
        last = s_out[-1] if s_nnz else np.int32(0)
        s_out = np.concatenate([s_out, np.full(pad, last, np.int32)])
        s_in = np.concatenate([s_in, np.zeros(pad, np.int32)])
        s_vm = np.concatenate([s_vm, np.zeros((pad, 2), np.uint32)])
    return cols2d, vals2d, (s_out, s_in, s_vm, s_nnz, rowptr), nnz, int(ell)


def make_wide_hybrid_op(f: GFpWide, out_idx, in_idx, vals, out_dim: int,
                        in_dim: int, ell: int | None = None,
                        chunk: int = DEFAULT_CHUNK) -> WideHybridOp:
    cols2d, vals2d, spill_t, nnz, ell = build_wide_hybrid_arrays(
        f, out_idx, in_idx, vals, out_dim, ell=ell)
    s_out, s_in, s_vm, s_nnz, rowptr = spill_t
    spill = WideSparseOp(out_dim=out_dim, in_dim=in_dim, nnz=s_nnz,
                         out_idx=jnp.asarray(s_out), in_idx=jnp.asarray(s_in),
                         val_mont=jnp.asarray(s_vm),
                         rowptr=jnp.asarray(rowptr))
    return WideHybridOp(out_dim=out_dim, in_dim=in_dim, nnz=nnz, ell=ell,
                        cols=jnp.asarray(cols2d), vals=jnp.asarray(vals2d),
                        spill=spill)


def _spmv_spill_prefix(f: GFpWide, op: WideSparseOp, x, out_rows: int):
    """Scatter-free spill reduction: 5-limb prefix sums + rowptr diffs.

    Safe because no output row holds more than 2^17 spill entries
    (the slab absorbed the first `ell` of every row, and rows that dense
    would have driven `ell` up — the same argument as the narrow path).
    """
    n = x.shape[1]
    prod = gw.mont_mul(f, op.val_mont[:, None, :], x[op.in_idx])  # (nnzp,n,2)
    limbs = gw.limb_split(prod).reshape(prod.shape[0], n * N_LIMBS)
    pref = jnp.cumsum(limbs, axis=0, dtype=u32)
    pref = jnp.concatenate([jnp.zeros((1, n * N_LIMBS), u32), pref])
    seg = pref[op.rowptr[1:]] - pref[op.rowptr[:-1]]     # (out_dim, n*5)
    y = gw.limb_combine(f, seg.reshape(op.out_dim, n, N_LIMBS))
    if out_rows > op.out_dim:
        y = jnp.pad(y, ((0, out_rows - op.out_dim), (0, 0), (0, 0)))
    return y


# slab-walk unroll limit, as ops/spmm.py (set before the H100 port;
# not measured on the H100, ROADMAP C5)
_ELL_UNROLL = 32


def spmv_wide(f: GFpWide, op: WideHybridOp, x, out_rows: int | None = None):
    """y = op * x mod p for pair blocks x (in_dim, n, 2) -> (out_rows, n, 2).

    The slab walk defers the mod-p reduction: each slot's Montgomery
    product is limb-split into 15-bit u32 limbs and ADDED (exact while
    ell <= 2^17 terms per limb sum), with ONE limb_combine fold after the
    walk — the narrow path's deferred-reduction idiom (ops/spmm.py)
    lifted to pairs.  The alternative — per-slot pair modadd (64-bit add
    + compare + conditional subtract per slot) — measures slower in the
    `real` vs `deferred` variants of benchmarks/ablate_wide.py (PERF.md
    "Wide-field iteration ablation" records the numbers per backend).
    Bit-identical: both forms produce the canonical representative in
    [0, p).
    """
    if out_rows is None:
        out_rows = op.out_dim
    n = x.shape[1]
    out_pad = op.cols.shape[0]
    deferred = op.ell <= gw.LIMB_SUM_MAX  # exactness cap (always, in practice)

    def slab_step(k, acc):
        ck = jax.lax.dynamic_index_in_dim(op.cols, k, 1, keepdims=False)
        vk = jax.lax.dynamic_index_in_dim(op.vals, k, 1, keepdims=False)
        prod = gw.mont_mul(f, vk[:, None, :], x[ck])
        return (acc + gw.limb_split(prod) if deferred
                else gw.modadd(f, acc, prod))

    tail = N_LIMBS if deferred else 2
    # fori carry: join of x's and the slab leaves' vma
    acc = gfp.zeros_vma_like((x, op.vals), (out_pad, n, tail))
    if op.ell <= _ELL_UNROLL:
        for k in range(op.ell):
            prod = gw.mont_mul(f, op.vals[:, k][:, None, :], x[op.cols[:, k]])
            acc = (acc + gw.limb_split(prod) if deferred
                   else gw.modadd(f, acc, prod))
    else:
        acc = jax.lax.fori_loop(0, op.ell, slab_step, acc)
    y = gw.limb_combine(f, acc) if deferred else acc

    if op.spill.nnz != 0:
        y = gw.modadd(f, y, _spmv_spill_prefix(f, op.spill, x, out_pad))

    if out_rows > out_pad:
        y = jnp.pad(y, ((0, out_rows - out_pad), (0, 0), (0, 0)))
    elif out_rows < out_pad:
        y = y[:out_rows]
    return y


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class WideBandedOp:
    """Input-banded wide operator: part b gathers from x rows [lo_b, hi_b).

    Same policy as the narrow BandedOp (ops/spmm.py; set before the H100
    port, not measured on the H100, ROADMAP C5); the WIDE x-table is
    (in_dim, n, 2) uint32 — twice the bytes per element — so it reaches
    the table threshold at HALF the narrow in_dim.  Bit-exact with
    the monolithic layout: mod-p sums are associative.
    """
    out_dim: int
    in_dim: int
    nnz: int
    ell: int               # max part ell (observability; parts carry their own)
    bounds: tuple          # ((lo, hi), ...) static band bounds
    parts: tuple           # tuple[WideHybridOp, ...]

    def tree_flatten(self):
        return ((self.parts,), (self.out_dim, self.in_dim, self.nnz,
                                self.ell, self.bounds))

    @classmethod
    def tree_unflatten(cls, aux, children):
        (parts,) = children
        out_dim, in_dim, nnz, ell, bounds = aux
        return cls(out_dim, in_dim, nnz, ell, bounds, tuple(parts))


# Rows-per-band floor: the narrow guard (80k) bounds per-band slab padding,
# whose cost scales with SLOT BYTES; wide slots are 2x the bytes, so the
# equal-overhead floor sits at half the rows.
BAND_MIN_ROWS_WIDE = 40_000


def wide_band_count(in_dim: int, n: int) -> int:
    """Bands for an (in_dim, n, 2) uint32 gather table — the narrow
    band_count policy evaluated at 8 bytes/element (ops/spmm.py:648)."""
    from block_lanczos_tpu.ops.spmm import (BAND_MAX_PARTS, BAND_MIN_PARTS,
                                            BAND_TABLE_BYTES,
                                            BAND_TARGET_BYTES)
    table = in_dim * n * 8
    if table <= BAND_TABLE_BYTES:
        return 1
    if BAND_TARGET_BYTES // (n * 8) < BAND_MIN_ROWS_WIDE:
        return 1
    nb = max(BAND_MIN_PARTS, -(-table // BAND_TARGET_BYTES))
    if nb > BAND_MAX_PARTS:
        return 1
    return nb


def make_wide_banded_op(f: GFpWide, out_idx, in_idx, vals, out_dim: int,
                        in_dim: int, nbands: int,
                        chunk: int = DEFAULT_CHUNK) -> WideBandedOp:
    """Split the input dimension into nbands bands, one WideHybridOp each
    (cut points shared with the narrow path via spmm.band_bounds)."""
    from block_lanczos_tpu.ops.spmm import band_bounds
    out_idx = np.asarray(out_idx, np.int64)
    in_idx = np.asarray(in_idx, np.int64)
    vals = np.asarray(vals, dtype=object)
    bounds, parts = [], []
    for lo, hi in band_bounds(in_dim, nbands):
        sel = (in_idx >= lo) & (in_idx < hi)
        parts.append(make_wide_hybrid_op(
            f, out_idx[sel], (in_idx[sel] - lo).astype(np.int32), vals[sel],
            out_dim, hi - lo, chunk=chunk))
        bounds.append((lo, hi))
    return WideBandedOp(out_dim=out_dim, in_dim=in_dim, nnz=len(vals),
                        ell=max(p.ell for p in parts),
                        bounds=tuple(bounds), parts=tuple(parts))


def spmv_wide_banded(f: GFpWide, op: WideBandedOp, x,
                     out_rows: int | None = None):
    """y = op * x over the input bands; each part gathers from its slice."""
    y = None
    for (lo, hi), part in zip(op.bounds, op.parts):
        yb = spmv_wide(f, part, jax.lax.slice_in_dim(x, lo, hi),
                       out_rows=out_rows)
        y = yb if y is None else gw.modadd(f, y, yb)
    return y


def apply_wide(f: GFpWide, op, x, out_rows: int | None = None):
    """Dispatch: y = op * x for monolithic or banded wide layouts."""
    if isinstance(op, WideBandedOp):
        return spmv_wide_banded(f, op, x, out_rows)
    return spmv_wide(f, op, x, out_rows)


def make_wide_op_auto(f: GFpWide, out_idx, in_idx, vals, out_dim: int,
                      in_dim: int, n: int, chunk: int = DEFAULT_CHUNK):
    """Policy-selected wide operator: banded when the (in_dim, n) pair
    gather table exceeds the banding threshold, else monolithic."""
    nb = wide_band_count(in_dim, n)
    if nb > 1:
        return make_wide_banded_op(f, out_idx, in_idx, vals, out_dim,
                                   in_dim, nb, chunk=chunk)
    return make_wide_hybrid_op(f, out_idx, in_idx, vals, out_dim, in_dim,
                               chunk=chunk)


def spmv_wide_oracle(p: int, nrows: int, i, j, x_obj, v_obj):
    """Host oracle: y[i] += x * v[j] mod p with Python-int arithmetic."""
    n = v_obj.shape[1]
    y = np.zeros((nrows, n), dtype=object)
    for k in range(len(x_obj)):
        y[i[k]] = (y[i[k]] + int(x_obj[k]) * v_obj[j[k]]) % p
    return y
