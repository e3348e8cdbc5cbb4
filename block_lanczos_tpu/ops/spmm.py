"""Sparse matrix-times-vector-block (SpMM) over GF(p) on the device.

The reference's hot loop (62% of runtime) is a COO scatter with a `% prime`
after every FMA (reference: sequential/lanczos_modp.c:266-287).  This
formulation instead:

  * stores the matrix twice, row-sorted and column-sorted, so both y = M*x
    and y = M^T*x are gather + segment-sum over *sorted* output ids,
  * keeps coefficients pre-converted to the Montgomery domain at load time,
    so each product is ONE mont_mul (exact, no divide),
  * defers reduction: products < p < 2^30 are split into 15-bit limbs and
    accumulated with plain uint32 adds (the uint32 analogue of the reference's
    "accumulate in u64, reduce once" OpenMP optimization,
    reference: openMP/lanczos_modp.c:329-374) — overflow-safe by
    construction for segments up to 2^17 elements,
  * chunks the nnz axis with lax.scan so the temporary (chunk, n) product
    block stays small and every segment-within-chunk respects the limb bound.

All shapes are static; the nnz axis is padded to a multiple of the chunk
size with zero-valued entries (additive identity).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.ops import gfp
from block_lanczos_tpu.ops.gfp import GFp, u32
from block_lanczos_tpu.utils.mmio import COOMatrix

# Max entries per scan chunk == max segment length inside one segment-sum.
# Must be <= gfp.LIMB_SUM_MAX.
DEFAULT_CHUNK = 1 << 17


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SparseOp:
    """One direction of a sparse operator: y[out] += val * x[in].

    Entries are sorted by out_idx; val_mont is in the Montgomery domain
    (val * R mod p) so mont_mul(val_mont, x) == val * x mod p exactly.
    rowptr is the CSR-style segment-boundary array over the TRUE entries
    (padding lives past rowptr[out_dim] or contributes zeros), which lets
    the segment reduction run scatter-free via prefix sums.
    """
    out_dim: int
    in_dim: int
    nnz: int          # true nnz (before padding)
    chunk: int
    seg_safe: bool    # max segment length <= LIMB_SUM_MAX
    out_idx: jax.Array  # (padded_nnz,) int32, sorted
    in_idx: jax.Array   # (padded_nnz,) int32
    val_mont: jax.Array  # (padded_nnz,) uint32
    rowptr: jax.Array   # (out_dim + 1,) int32

    def tree_flatten(self):
        return ((self.out_idx, self.in_idx, self.val_mont, self.rowptr),
                (self.out_dim, self.in_dim, self.nnz, self.chunk,
                 self.seg_safe))

    @classmethod
    def tree_unflatten(cls, aux, children):
        out_idx, in_idx, val_mont, rowptr = children
        out_dim, in_dim, nnz, chunk, seg_safe = aux
        return cls(out_dim, in_dim, nnz, chunk, seg_safe,
                   out_idx, in_idx, val_mont, rowptr)


def _sort_by(key_idx, other_idx, vals, key_dim):
    """Sort by (key_idx, other_idx): row-major with ascending column within
    each row.  The secondary key costs nothing for correctness (segment sums
    are order-independent) and improves gather locality — consecutive nnz
    hit ascending x rows."""
    order = np.lexsort((other_idx, key_idx))
    return (np.asarray(key_idx, np.int32)[order],
            np.asarray(other_idx, np.int32)[order],
            np.asarray(vals, np.uint32)[order])


def build_op_arrays(f: GFp, out_idx, in_idx, vals, out_dim: int,
                    chunk: int = DEFAULT_CHUNK, pad_to: int | None = None,
                    sort: bool = True):
    """Host-side SparseOp array construction (sort, Montgomery, padding).

    Returns (out_idx, in_idx, val_mont, nnz, rowptr, seg_safe) as NumPy
    arrays padded to a multiple of `chunk` (at least `pad_to` entries if
    given — used to equalize shard shapes for shard_map).
    """
    assert chunk <= gfp.LIMB_SUM_MAX
    out_idx = np.asarray(out_idx, np.int32)
    in_idx = np.asarray(in_idx, np.int32)
    vals = np.asarray(vals, np.uint32)
    if sort:
        out_idx, in_idx, vals = _sort_by(out_idx, in_idx, vals, out_dim)
    nnz = len(vals)
    if f.use_mont:  # val * R mod p (fits u64: val < 2^30, R = 2^32)
        vm = ((vals.astype(np.uint64) << 32) % np.uint64(f.p)).astype(np.uint32)
    else:
        vm = vals % np.uint32(f.p)
    # CSR-style segment boundaries over the true (sorted) entries
    rowptr = np.searchsorted(out_idx, np.arange(out_dim + 1)).astype(np.int32)
    seg_safe = bool((np.diff(rowptr) <= gfp.LIMB_SUM_MAX).all())
    target = max(nnz, pad_to or 0, 1)
    # The chunked-scan fallback reshapes to (nchunks, chunk), so its arrays
    # must be chunk multiples; the prefix path accepts any length, and
    # rounding a few-thousand-entry spill sidecar up to 2^17 was measured
    # to dominate the slot count of balanced sharded partitions (round-3
    # skew work) — pad those to the 8-row tile only.
    target += (-target) % (8 if seg_safe else chunk)
    pad = target - nnz
    if pad:
        # zero-valued padding entries scatter 0; pad out_idx with the last
        # (max) id so the array stays sorted for indices_are_sorted=True
        last = out_idx[-1] if nnz else np.int32(0)
        out_idx = np.concatenate([out_idx, np.full(pad, last, np.int32)])
        in_idx = np.concatenate([in_idx, np.zeros(pad, np.int32)])
        vm = np.concatenate([vm, np.zeros(pad, np.uint32)])
    return out_idx, in_idx, vm, nnz, rowptr, seg_safe


def make_sparse_op(f: GFp, out_idx, in_idx, vals, out_dim: int, in_dim: int,
                   chunk: int = DEFAULT_CHUNK, sort: bool = True) -> SparseOp:
    """Build a device SparseOp from host COO arrays (values in [0, p))."""
    oi, ii, vm, nnz, rowptr, seg_safe = build_op_arrays(
        f, out_idx, in_idx, vals, out_dim, chunk=chunk, sort=sort)
    return SparseOp(out_dim=out_dim, in_dim=in_dim, nnz=nnz, chunk=chunk,
                    seg_safe=seg_safe,
                    out_idx=jnp.asarray(oi), in_idx=jnp.asarray(ii),
                    val_mont=jnp.asarray(vm), rowptr=jnp.asarray(rowptr))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SpMatrix:
    """A sparse matrix with both application directions resident on device."""
    nrows: int
    ncols: int
    nnz: int
    fwd: SparseOp  # y (nrows) = M  * x (ncols)
    bwd: SparseOp  # y (ncols) = M^T * x (nrows)

    def tree_flatten(self):
        return ((self.fwd, self.bwd), (self.nrows, self.ncols, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        fwd, bwd = children
        nrows, ncols, nnz = aux
        return cls(nrows, ncols, nnz, fwd, bwd)

    @staticmethod
    def from_coo(f: GFp, M: COOMatrix, chunk: int = DEFAULT_CHUNK,
                 layout: str = "hybrid", delta: bool = True,
                 n: int = 1) -> "SpMatrix":
        """n is the block width the operator will be applied at — it sizes
        the gather table (in_dim x n u32) for the input-banding policy."""
        if layout == "hybrid":
            def mk(oi, ii, out_dim, in_dim):
                nb = band_count(in_dim, n)
                if nb > 1:
                    return make_banded_op(f, oi, ii, M.x, out_dim, in_dim,
                                          nb, chunk=chunk, delta=delta)
                return make_hybrid_op(f, oi, ii, M.x, out_dim, in_dim,
                                      chunk=chunk, delta=delta)
            fwd = mk(M.i, M.j, M.nrows, M.ncols)
            bwd = mk(M.j, M.i, M.ncols, M.nrows)
        elif layout == "coo":
            fwd = make_sparse_op(f, M.i, M.j, M.x, M.nrows, M.ncols, chunk)
            bwd = make_sparse_op(f, M.j, M.i, M.x, M.ncols, M.nrows, chunk)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        return SpMatrix(M.nrows, M.ncols, M.nnz, fwd, bwd)


def spmv_block(f: GFp, op: SparseOp, x, out_rows: int | None = None):
    """y = op * x exactly mod p.

    x: (in_pad, n) uint32 with in_pad >= op.in_dim; returns (out_rows, n)
    with out_rows >= op.out_dim (default op.out_dim); rows beyond the true
    output dimension are zero, matching the reference's zero-padded blocks.

    Fast path: gather + ONE fused elementwise mont_mul + limb prefix-sums +
    rowptr differences.  The segment reduction is scatter-free (set before
    the H100 port, for a scatter that serialized on colliding indices; a
    native scatter-add is not measured on the H100, ROADMAP A1): with
    entries sorted by output row, the segment sum is the
    difference of an (exclusive) running prefix at the row boundaries;
    uint32 wrap-around keeps the differences exact because every true
    segment sum of 15-bit limbs stays below 2^32 (seg_safe).
    """
    if isinstance(op, HybridOp):
        return spmv_hybrid(f, op, x, out_rows)
    if out_rows is None:
        out_rows = op.out_dim
    if op.seg_safe:
        return _spmv_prefix(f, op, x, out_rows)
    return _spmv_scan(f, op, x, out_rows)


def _spmv_prefix(f: GFp, op: SparseOp, x, out_rows: int):
    n = x.shape[1]
    prod = gfp.mont_mul(f, op.val_mont[:, None], x[op.in_idx])  # (nnzp, n)
    hi, lo = gfp.limb_split(prod)
    # one fused prefix over both limbs (2n lanes) and one boundary gather
    hl = jnp.concatenate([hi, lo], axis=1)            # (nnzp, 2n)
    pref = jnp.cumsum(hl, axis=0, dtype=u32)
    pref = jnp.concatenate([jnp.zeros((1, 2 * n), u32), pref])
    seg = pref[op.rowptr[1:]] - pref[op.rowptr[:-1]]  # wrap-exact (< 2^32)
    y = gfp.limb_combine(f, seg[:, :n], seg[:, n:])
    if out_rows > op.out_dim:
        y = jnp.pad(y, ((0, out_rows - op.out_dim), (0, 0)))
    return y


def _spmv_scan(f: GFp, op: SparseOp, x, out_rows: int):
    """Fallback for pathological segment lengths (> 2^17 nnz in one row):
    chunked scan where each chunk's segments are bounded by the chunk size."""
    n = x.shape[1]
    out_idx, in_idx, val_mont = op.out_idx, op.in_idx, op.val_mont
    rem = (-out_idx.shape[0]) % op.chunk
    if rem:  # arrays built for the prefix path are only 8-aligned
        out_idx = jnp.pad(out_idx, (0, rem), mode="edge")  # keep sorted
        in_idx = jnp.pad(in_idx, (0, rem))
        val_mont = jnp.pad(val_mont, (0, rem))  # zero values scatter 0
    padded_nnz = out_idx.shape[0]
    nchunks = padded_nnz // op.chunk

    def one_chunk(oi, ii, vm):
        prod = gfp.mont_mul(f, vm[:, None], x[ii])        # (chunk, n), < p
        hi, lo = gfp.limb_split(prod)
        hi_s = jax.ops.segment_sum(hi, oi, num_segments=out_rows,
                                   indices_are_sorted=True)
        lo_s = jax.ops.segment_sum(lo, oi, num_segments=out_rows,
                                   indices_are_sorted=True)
        return hi_s, lo_s

    if nchunks == 1:
        hi_s, lo_s = one_chunk(out_idx, in_idx, val_mont)
        return gfp.limb_combine(f, hi_s, lo_s)

    def body(y, chunk):
        oi, ii, vm = chunk
        hi_s, lo_s = one_chunk(oi, ii, vm)
        return gfp.modadd(f, y, gfp.limb_combine(f, hi_s, lo_s)), None

    chunks = (out_idx.reshape(nchunks, op.chunk),
              in_idx.reshape(nchunks, op.chunk),
              val_mont.reshape(nchunks, op.chunk))
    # carry must join x's vma with the operator leaves' (the body reads
    # val_mont, varying over BOTH mesh axes where x may not be)
    y0 = gfp.zeros_vma_like((x, val_mont), (out_rows, n))
    y, _ = jax.lax.scan(body, y0, chunks)
    return y


# ---------------------------------------------------------------------------
# Hybrid ELL + spill layout — the production SpMV path
# ---------------------------------------------------------------------------
#
# The prefix-sum path reads/writes O(nnz * n) prefix state; a k-loop over a
# fixed-width ELL slab — L gathers of (rows, n) with in-register modadd
# accumulation — writes no such state (layout set before the H100 port;
# not measured on the H100, ROADMAP C5).  Rows denser than the chosen width spill their
# excess entries to a small COO sidecar handled by the prefix path, which
# keeps the slab width near the mean nnz per row even for skewed matrices.
# Static shapes everywhere.

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HybridOp:
    """y[r] = sum_k vals[r,k] * x[cols[r,k]]  (+ spill)  exactly mod p.

    Column storage comes in two interchangeable encodings:
      * absolute: `cols` is the (out_pad, L) int32 column slab,
      * delta:    `cols` is None; each row's slab entries are column-sorted
        and stored as `col0` (first column, int32) plus `dcols` (u16 gaps,
        (out_pad, L-1)).  Halves the index-stream bytes — on a
        bandwidth-bound SpMV, bytes are time (PERF.md "the gather wall").
    Entries whose gap exceeds 65535 live in the spill sidecar instead.
    """
    out_dim: int
    in_dim: int
    nnz: int
    ell: int               # slab width L (static)
    cols: jax.Array | None  # (out_pad, L) int32, or None in delta mode
    vals: jax.Array        # (out_pad, L) uint32, Montgomery form
    spill: SparseOp        # possibly empty (nnz == 0)
    col0: jax.Array | None = None   # (out_pad,) int32 (delta mode)
    dcols: jax.Array | None = None  # (out_pad, L-1) uint16 (delta mode)

    def tree_flatten(self):
        return ((self.cols, self.vals, self.spill, self.col0, self.dcols),
                (self.out_dim, self.in_dim, self.nnz, self.ell))

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals, spill, col0, dcols = children
        out_dim, in_dim, nnz, ell = aux
        return cls(out_dim, in_dim, nnz, ell, cols, vals, spill, col0, dcols)


def _ell_candidates(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts)
    if counts.size == 0 or counts.max() == 0:
        return np.array([1], np.int64)
    cands = np.unique(np.concatenate([
        np.percentile(counts[counts > 0], [50, 75, 90, 95, 99, 100])
        .astype(np.int64),
        [1, int(counts.mean() + 1)]]))
    return cands[cands >= 1]


def choose_ell_width(counts: np.ndarray, spill_cost: float = 3.0) -> int:
    """Pick the slab width minimizing  rows*L + spill_cost*spill_nnz(L).

    spill_cost models the prefix path's per-entry overhead vs a slab slot.
    """
    return choose_ell_width_multi([counts], spill_cost=spill_cost)


def choose_ell_width_multi(counts_list, spill_cost: float = 3.0) -> int:
    """One slab width for SEVERAL shards, minimizing the TOTAL cost
    sum_s(rows_s*L + spill_cost*spill_s(L)).

    shard_map needs a uniform per-shard width; taking the max of per-shard
    choices lets ONE dense shard inflate every shard's slab (measured
    5.5-12.5x total slot inflation on power-law matrices vs single device —
    the reference's raw-COO MPI shards have no such coupling,
    mpi/lanczos_modp.c:623-964).  Minimizing the summed cost instead makes
    the dense shard spill to its prefix-sum sidecar while the others keep
    slim slabs.
    """
    counts_list = [np.asarray(c) for c in counts_list]
    cands = sorted({int(L) for c in counts_list for L in _ell_candidates(c)})
    best, best_cost = 1, None
    for L in cands:
        cost = 0.0
        for c in counts_list:
            spill = int(np.maximum(c - L, 0).sum()) if c.size else 0
            cost += float(c.size * L + spill_cost * spill)
        if best_cost is None or cost < best_cost:
            best, best_cost = int(L), cost
    return best


def _within_row_positions(sorted_out_idx: np.ndarray) -> np.ndarray:
    """pos[e] = rank of entry e within its (sorted) out_idx run.

    O(nnz) sequential passes — np.repeat(starts, counts) and starts[oi]
    gathers both measured 30-70 s at 50M nnz on shared hosts.
    """
    nnz = len(sorted_out_idx)
    if nnz == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(nnz, dtype=np.int64)
    same = np.empty(nnz, bool)
    same[0] = False
    np.equal(sorted_out_idx[1:], sorted_out_idx[:-1], out=same[1:])
    run_start = np.where(same, 0, idx)  # run heads keep their index
    np.maximum.accumulate(run_start, out=run_start)
    return idx - run_start


class SlabArrays(tuple):
    """(cols, col0, dcols, vals) NumPy slab arrays; absolute mode has
    col0 is None is dcols, delta mode has cols is None."""
    __slots__ = ()

    def __new__(cls, cols, col0, dcols, vals):
        return tuple.__new__(cls, (cols, col0, dcols, vals))

    cols = property(lambda s: s[0])
    col0 = property(lambda s: s[1])
    dcols = property(lambda s: s[2])
    vals = property(lambda s: s[3])
    delta = property(lambda s: s[0] is None)


_DELTA_MAX = 1 << 16


def _delta_encode_slab(cols2d: np.ndarray, rvals2d: np.ndarray):
    """Column-sort each ELL row and re-encode columns as first-absolute +
    u16 gaps.  Entries with gaps >= 2^16 are evicted for the spill sidecar.

    Returns (col0, dcols, vals_sorted, (ev_rows, ev_cols, ev_vals)).
    Zero-valued slots are treated as empty (their products contribute 0).
    """
    out_pad, ell = cols2d.shape
    occ = rvals2d != 0
    key = np.where(occ, cols2d.astype(np.int64), np.int64(1) << 40)
    order = np.argsort(key, axis=1, kind="stable")
    cs = np.take_along_axis(cols2d, order, axis=1)
    vs = np.take_along_axis(rvals2d, order, axis=1)
    occ = vs != 0
    col0 = np.where(occ[:, 0], cs[:, 0], 0).astype(np.int32)
    dcols = np.zeros((out_pad, max(ell - 1, 0)), np.uint16)
    prev = col0.astype(np.int64)
    rows = np.arange(out_pad, dtype=np.int64)
    ev_r, ev_c, ev_v = [], [], []
    for k in range(1, ell):
        cur = cs[:, k].astype(np.int64)
        gap = cur - prev  # >= 0: occupied slots ascend within each row
        ok = occ[:, k] & (gap < _DELTA_MAX)
        bad = occ[:, k] & ~ok
        if bad.any():
            ev_r.append(rows[bad])
            ev_c.append(cs[bad, k].astype(np.int64))
            ev_v.append(vs[bad, k].copy())
            vs[bad, k] = 0
        dcols[:, k - 1] = np.where(ok, gap, 0).astype(np.uint16)
        prev = np.where(ok, cur, prev)
    cat = (lambda xs, dt: np.concatenate(xs) if xs
           else np.zeros(0, dt))
    return col0, dcols, vs, (cat(ev_r, np.int64), cat(ev_c, np.int64),
                             cat(ev_v, np.uint32))


def build_hybrid_arrays(f: GFp, out_idx, in_idx, vals, out_dim: int,
                        out_pad: int, ell: int,
                        chunk: int = DEFAULT_CHUNK,
                        spill_pad_to: int | None = None, sort: bool = True,
                        delta: bool = True):
    """Host-side construction of the ELL slab + spill COO (NumPy arrays).

    Returns (slab, spill_tuple, nnz) where slab is a SlabArrays and
    spill_tuple is the build_op_arrays output for the overflow entries.
    With delta=True (default) the column slab is u16-gap encoded unless
    more than ~1% of slab entries would need eviction (then absolute).
    """
    out_idx = np.asarray(out_idx, np.int64)
    in_idx = np.asarray(in_idx, np.int64)
    vals = np.asarray(vals, np.uint32)
    nnz = len(vals)
    sorted_native = False
    if sort and nnz:
        # native counting sort by row: O(nnz) vs lexsort+gathers (~50 s at
        # 50M nnz).  Within-row order becomes file order instead of
        # column-sorted — irrelevant: exact sums are order-independent and
        # gather cost is locality-independent (PERF.md).
        from block_lanczos_tpu import native
        csr = native.coo_to_csr(out_dim, out_idx.astype(np.int32),
                                in_idx.astype(np.int32), vals)
        if csr is not None:
            rowptr_full, in_idx, vals = csr
            in_idx = in_idx.astype(np.int64)
            counts = np.diff(rowptr_full)
            # reconstruct sorted row ids via run-head max-scan (rows ascend)
            out_idx = np.zeros(nnz, np.int64)
            heads = rowptr_full[:-1][counts > 0]
            out_idx[heads] = np.nonzero(counts > 0)[0]
            np.maximum.accumulate(out_idx, out=out_idx)
            sorted_native = True
    if sort and not sorted_native:
        order = np.lexsort((in_idx, out_idx))
        out_idx, in_idx, vals = out_idx[order], in_idx[order], vals[order]
    if not sorted_native:
        counts = np.bincount(out_idx, minlength=out_dim) if nnz else \
            np.zeros(out_dim, np.int64)
    pos = _within_row_positions(out_idx)

    in_slab = pos < ell
    # flat-index fill: ~4x faster than 2D fancy assignment at 50M+ nnz
    flat = (out_idx * ell + pos)[in_slab]
    cols2d = np.zeros(out_pad * ell, np.int32)
    rvals2d = np.zeros(out_pad * ell, np.uint32)  # raw values (pre-Montgomery)
    cols2d[flat] = in_idx[in_slab]
    rvals2d[flat] = vals[in_slab]
    cols2d = cols2d.reshape(out_pad, ell)
    rvals2d = rvals2d.reshape(out_pad, ell)

    sp = ~in_slab
    sp_o = out_idx[sp].astype(np.int64)
    sp_i = in_idx[sp].astype(np.int64)
    sp_v = vals[sp]

    def to_mont2d(rv):
        if f.use_mont:  # val * R mod p (fits u64: val < 2^30, R = 2^32)
            return ((rv.astype(np.uint64) << 32)
                    % np.uint64(f.p)).astype(np.uint32)
        return rv % np.uint32(f.p)

    slab, evicted = None, 0
    if delta and ell > 0 and out_pad > 500_000:
        # cheap pre-check on big slabs: the full encode (per-row argsort of
        # out_pad x ell) costs ~60 s at 51M nnz, which is wasted when the
        # eviction policy will reject it anyway — extrapolate from a sample
        sample = np.linspace(0, out_pad - 1, 100_000).astype(np.int64)
        _c0, _dc, svs, (_r, _c, sev) = _delta_encode_slab(
            cols2d[sample], rvals2d[sample].copy())
        s_nnz = int((rvals2d[sample] != 0).sum())
        if len(sev) > max(8, s_nnz // 100):
            delta = False
    if delta and ell > 0:
        col0, dcols, vs, (ev_r, ev_c, ev_v) = _delta_encode_slab(
            cols2d, rvals2d)
        slab_nnz = int(in_slab.sum())
        if len(ev_v) <= max(64, slab_nnz // 100):
            slab = SlabArrays(None, col0, dcols, to_mont2d(vs))
            evicted = len(ev_v)
            if evicted:
                sp_o = np.concatenate([sp_o, ev_r])
                sp_i = np.concatenate([sp_i, ev_c])
                sp_v = np.concatenate([sp_v, ev_v])
    if slab is None:
        slab = SlabArrays(cols2d, None, None, to_mont2d(rvals2d))

    spill_tuple = build_op_arrays(
        f, sp_o.astype(np.int32), sp_i.astype(np.int32),
        sp_v, out_dim, chunk=chunk, pad_to=spill_pad_to,
        sort=evicted > 0)  # appended evictions break the existing row order
    return slab, spill_tuple, nnz


def make_hybrid_op(f: GFp, out_idx, in_idx, vals, out_dim: int, in_dim: int,
                   out_pad: int | None = None, ell: int | None = None,
                   chunk: int = DEFAULT_CHUNK,
                   delta: bool = True) -> HybridOp:
    if out_pad is None:
        out_pad = out_dim
    if ell is None:
        counts = (np.bincount(np.asarray(out_idx, np.int64),
                              minlength=out_dim)
                  if len(vals) else np.zeros(out_dim, np.int64))
        ell = choose_ell_width(counts)
    slab, spill_t, nnz = build_hybrid_arrays(
        f, out_idx, in_idx, vals, out_dim, out_pad, ell, chunk=chunk,
        delta=delta)
    s_o, s_i, s_v, s_nnz, s_rp, s_safe = spill_t
    spill = SparseOp(out_dim=out_dim, in_dim=in_dim, nnz=s_nnz, chunk=chunk,
                     seg_safe=s_safe, out_idx=jnp.asarray(s_o),
                     in_idx=jnp.asarray(s_i), val_mont=jnp.asarray(s_v),
                     rowptr=jnp.asarray(s_rp))
    return HybridOp(out_dim=out_dim, in_dim=in_dim, nnz=nnz, ell=ell,
                    cols=None if slab.delta else jnp.asarray(slab.cols),
                    vals=jnp.asarray(slab.vals), spill=spill,
                    col0=jnp.asarray(slab.col0) if slab.delta else None,
                    dcols=jnp.asarray(slab.dcols) if slab.delta else None)


# L-loop unroll limit: beyond this use fori_loop to bound trace size
# (set before the H100 port; not measured on the H100, ROADMAP C5)
_ELL_UNROLL = 32


def spmv_hybrid(f: GFp, op: HybridOp, x, out_rows: int | None = None):
    """y = op * x exactly mod p; returns (out_rows, n), zero-padded."""
    if out_rows is None:
        out_rows = op.out_dim
    n = x.shape[1]
    out_pad = op.vals.shape[0]

    # fori carries need the JOIN of x's and the slab leaves' vma (the
    # slab walk reads op.vals/op.cols, varying over both mesh axes)
    y = gfp.zeros_vma_like((x, op.vals), (out_pad, n))
    if op.dcols is not None:
        # delta encoding: reconstruct the column chain while streaming.
        # The running base is a single (out_pad,) int32 vector; empty slots
        # carry gap 0 and value 0, so the chain is correct for short rows.
        base = op.col0

        def delta_step(k, carry):
            y, base = carry
            base = base + jax.lax.dynamic_index_in_dim(
                op.dcols.T, k - 1, 0, keepdims=False).astype(jnp.int32)
            vk = jax.lax.dynamic_index_in_dim(op.vals.T, k, 0, keepdims=False)
            return gfp.modadd(f, y, gfp.mont_mul(f, vk[:, None], x[base])), base

        y = gfp.modadd(f, y, gfp.mont_mul(f, op.vals[:, 0][:, None], x[base]))
        if op.ell <= _ELL_UNROLL:
            for k in range(1, op.ell):
                base = base + op.dcols[:, k - 1].astype(jnp.int32)
                y = gfp.modadd(
                    f, y, gfp.mont_mul(f, op.vals[:, k][:, None], x[base]))
        else:
            y, base = jax.lax.fori_loop(1, op.ell, delta_step, (y, base))
    else:
        def slab_step(k, y):
            ck = jax.lax.dynamic_index_in_dim(op.cols.T, k, 0, keepdims=False)
            vk = jax.lax.dynamic_index_in_dim(op.vals.T, k, 0, keepdims=False)
            return gfp.modadd(f, y, gfp.mont_mul(f, vk[:, None], x[ck]))

        if op.ell <= _ELL_UNROLL:
            for k in range(op.ell):
                y = gfp.modadd(
                    f, y,
                    gfp.mont_mul(f, op.vals[:, k][:, None], x[op.cols[:, k]]))
        else:
            y = jax.lax.fori_loop(0, op.ell, slab_step, y)

    if op.spill.nnz != 0:
        y_spill = spmv_block(f, op.spill, x, out_rows=out_pad)
        y = gfp.modadd(f, y, y_spill)

    if out_rows > out_pad:
        y = jnp.pad(y, ((0, out_rows - out_pad), (0, 0)))
    elif out_rows < out_pad:
        y = y[:out_rows]
    return y


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BandedOp:
    """Input-banded hybrid operator: part b covers x rows [lo_b, hi_b).

    y = sum_b part_b(x[lo_b:hi_b]) exactly mod p.  Banding keeps each slab
    walk's gather table small (set before the H100 port; not measured on
    the H100, ROADMAP C5).  Bit-exact with the monolithic layout: mod-p
    sums are associative.
    """
    out_dim: int
    in_dim: int
    nnz: int
    bounds: tuple          # ((lo, hi), ...) static band bounds
    parts: tuple           # tuple[HybridOp, ...]

    def tree_flatten(self):
        return ((self.parts,), (self.out_dim, self.in_dim, self.nnz,
                                self.bounds))

    @classmethod
    def tree_unflatten(cls, aux, children):
        (parts,) = children
        out_dim, in_dim, nnz, bounds = aux
        return cls(out_dim, in_dim, nnz, bounds, tuple(parts))


# Band policy constants (set before the H100 port; not measured on the
# H100, ROADMAP C5): band gather tables above ~3.2 MB into ~1.6 MB
# slices, at least 3 and at most 6 bands, never thinner than 80k rows
# (per-band slab padding grows with the number of parts).  Outputs
# are bit-identical under any setting (tests/test_sparse_dense.py fuzz).
BAND_TABLE_BYTES = 32 * (1 << 20) // 10  # ~3.2 MB: band above this
BAND_TARGET_BYTES = 16 * (1 << 20) // 10  # ~1.6 MB per band
BAND_MIN_PARTS = 3
BAND_MAX_PARTS = 6
BAND_MIN_ROWS = 80_000


def band_count(in_dim: int, n: int) -> int:
    """Number of input bands for an (in_dim, n) uint32 gather table.

    1 (monolithic) unless the table exceeds BAND_TABLE_BYTES AND the
    target-sized band still holds enough rows for a dense slab AND the
    whole table splits into few enough bands that per-band slab padding
    stays negligible.  In practice this engages for n <= 4 with
    ~0.2M < in_dim <= ~0.65M.
    """
    table = in_dim * n * 4
    if table <= BAND_TABLE_BYTES:
        return 1
    if BAND_TARGET_BYTES // (n * 4) < BAND_MIN_ROWS:
        return 1
    nb = max(BAND_MIN_PARTS, -(-table // BAND_TARGET_BYTES))
    if nb > BAND_MAX_PARTS:
        return 1
    return nb


def band_bounds(in_dim: int, nbands: int):
    """((lo, hi), ...) covering [0, in_dim) in 8-aligned bands.

    Single source of truth for the band split — the single-device
    make_banded_op and the per-shard mesh banding
    (parallel/sharding._build_dir_banded) must cut identically or the two
    paths' layouts silently diverge.
    """
    nbands = max(1, min(int(nbands), max(in_dim, 1)))
    band = -(-in_dim // nbands)
    band += (-band) % 8
    out = []
    for b in range(nbands):
        lo, hi = b * band, min((b + 1) * band, in_dim)
        if lo >= hi:
            break
        out.append((lo, hi))
    return tuple(out)


def make_banded_op(f: GFp, out_idx, in_idx, vals, out_dim: int, in_dim: int,
                   nbands: int, chunk: int = DEFAULT_CHUNK,
                   delta: bool = True) -> BandedOp:
    """Split the input dimension into nbands bands, one HybridOp each."""
    in_idx = np.asarray(in_idx, np.int64)
    out_idx = np.asarray(out_idx, np.int64)
    vals = np.asarray(vals, np.uint32)
    bounds, parts = [], []
    for lo, hi in band_bounds(in_dim, nbands):
        sel = (in_idx >= lo) & (in_idx < hi)
        parts.append(make_hybrid_op(
            f, out_idx[sel], (in_idx[sel] - lo).astype(np.int32), vals[sel],
            out_dim, hi - lo, chunk=chunk, delta=delta))
        bounds.append((lo, hi))
    return BandedOp(out_dim=out_dim, in_dim=in_dim, nnz=len(vals),
                    bounds=tuple(bounds), parts=tuple(parts))


def spmv_banded(f: GFp, op: BandedOp, x, out_rows: int | None = None):
    """y = op * x over the input bands; each part gathers from its slice."""
    y = None
    for (lo, hi), part in zip(op.bounds, op.parts):
        yb = spmv_hybrid(f, part, jax.lax.slice_in_dim(x, lo, hi),
                         out_rows=out_rows)
        y = yb if y is None else gfp.modadd(f, y, yb)
    return y


def apply_op(f: GFp, op, x, out_rows: int | None = None):
    """Dispatch: y = op * x for any sparse layout."""
    if isinstance(op, BandedOp):
        return spmv_banded(f, op, x, out_rows)
    if isinstance(op, HybridOp):
        return spmv_hybrid(f, op, x, out_rows)
    return spmv_block(f, op, x, out_rows)


def spmv_reference_np(p: int, nrows, i, j, x, v):
    """Host oracle: y[i] += x*v[j] mod p with exact object/int64 arithmetic."""
    n = v.shape[1]
    y = np.zeros((nrows, n), np.uint64)
    np_p = np.uint64(p)
    for k in range(len(x)):  # slow; tests only
        y[i[k]] = (y[i[k]] + np.uint64(x[k]) * v[j[k]].astype(np.uint64)) % np_p
    return y.astype(np.uint32)
