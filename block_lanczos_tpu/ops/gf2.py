"""Bitsliced GF(2) kernels: 32 field elements per uint32 word.

p = 2 is the integer-factorization case — the reference's primary
application (doc/sujet.pdf section 1: "p=2 pour la factorisation").  Its
generic mod-p path spends a full uint32 per bit; here a block of n kernel
vectors (n a multiple of 32) packs into n/32 words per row:

  * addition is XOR, multiplication is AND — no Montgomery, no limbs,
  * the SpMV streams ONLY column indices (every surviving entry is 1 mod 2;
    entries that reduce to 0 are dropped at load), ~4x fewer bytes per
    iteration than the generic path,
  * Gram products are bit-parity contractions; the n x n matrices live as
    (n, W) word matrices,
  * the semi-inverse is Gauss-Jordan over GF(2): pivot = any set bit,
    normalization is a no-op, elimination is a masked XOR.

Same two-phase semi-inverse semantics and Thome recurrence as the generic
field (reference: sequential/lanczos_modp.c:342-438,456-492), so iterates
match the generic p=2 solver bit-for-bit on the same xoshiro stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.ops.gfp import u32

WORD = 32


def words(n: int) -> int:
    if n % WORD != 0:
        raise ValueError("bitsliced GF(2) requires n % 32 == 0")
    return n // WORD


def pack_bits_np(block01: np.ndarray) -> np.ndarray:
    """(N, n) 0/1 uint array -> (N, n/32) uint32 words (bit b = column b).

    Column c of the block lives in word c//32, bit c%32 (little-endian),
    matching the reference's column-major interpretation of the block.
    """
    N, n = block01.shape
    W = words(n)
    w = block01.astype(np.uint32).reshape(N, W, WORD)
    shifts = np.arange(WORD, dtype=np.uint32)
    return (w << shifts).sum(axis=2, dtype=np.uint32)


def unpack_bits_np(wordsarr: np.ndarray, n: int) -> np.ndarray:
    """(N, n/32) uint32 words -> (N, n) 0/1 uint32."""
    N, W = wordsarr.shape
    shifts = np.arange(WORD, dtype=np.uint32)
    bits = (wordsarr[:, :, None] >> shifts) & 1
    return bits.reshape(N, W * WORD).astype(np.uint32)[:, :n]


def xor_reduce(x, axis: int = 0):
    """XOR-reduction along an axis (exact, order-independent)."""
    return jax.lax.reduce(x, jnp.uint32(0),
                          jax.lax.bitwise_xor, (axis,))


def bit_of(wordsarr, k: int):
    """Extract bit-column k as a full mask (0 or 0xffffffff), shape (N,)."""
    w, b = k // WORD, k % WORD
    bit = (wordsarr[..., w] >> u32(b)) & u32(1)
    return jnp.where(bit == 1, u32(0xFFFFFFFF), u32(0))


# Unroll limit for matmul_gf2's k loop.  Beyond it, walk WORDS with a
# fori_loop (32 unrolled bit steps per word) to bound program size (set
# before the H100 port; not measured on the H100, ROADMAP C5).
_MATMUL_UNROLL = 128


def matmul_gf2(X_words, B_words, n_in: int):
    """(N, Win) bit block @ (n_in, Wout) bit matrix over GF(2).

    y[r] = XOR over k of (bit k of X row r) * B[k]; the k loop unrolls at
    trace time up to _MATMUL_UNROLL inputs, then switches to a word-level
    fori_loop (same math; bounded program size for wide blocks at scale).
    """
    N = X_words.shape[0]
    Wout = B_words.shape[1]
    if n_in <= _MATMUL_UNROLL:
        y = jnp.zeros((N, Wout), u32)
        for k in range(n_in):  # unrolled: no loop carry, vma-safe
            mask = bit_of(X_words, k)[:, None]           # (N, 1)
            y = y ^ (mask & B_words[k][None, :])
        return y

    assert n_in % WORD == 0  # block widths are multiples of 32 by contract

    def word_step(w, y):
        xw = jax.lax.dynamic_index_in_dim(X_words, w, 1, keepdims=False)
        for b in range(WORD):  # 32 unrolled bit steps per word
            bit = (xw >> u32(b)) & u32(1)
            mask = jnp.where(bit == 1, u32(0xFFFFFFFF), u32(0))[:, None]
            y = y ^ (mask & jax.lax.dynamic_index_in_dim(
                B_words, w * WORD + b, 0, keepdims=False)[None, :])
        return y

    from block_lanczos_tpu.ops.gfp import zeros_vma_like
    y0 = zeros_vma_like((X_words, B_words), (N, Wout))  # joined vma carry
    return jax.lax.fori_loop(0, n_in // WORD, word_step, y0)


# Row-chunk size for the Gram scan (module constant so tests can force the
# chunked path at small sizes).  2^14 rows bounds the per-chunk program
# shape, which compile time grows with (set before the H100 port; not
# measured on the H100, ROADMAP C5).  Outputs are bit-identical for any
# chunking (XOR associativity).
_GRAM_CHUNK = 1 << 14

# Unroll limit for gram_gf2's per-bit output-row loop.  The n=128 config
# (n_x = 2n = 256) stays on the fully-unrolled path; wider blocks take the
# fused single-reduce formulation whose program size is independent of n_x
# (set before the H100 port; not measured on the H100, ROADMAP C5).
_GRAM_UNROLL = 256


def gram_gf2(X_words, Y_words, n_x: int):
    """X^T @ Y over GF(2): (n_x, Wy) word matrix of parities.

    Row a = XOR-parity over rows of (bit a of X) & Y.  Chunked over rows;
    XOR is exact and order-independent so any chunking is bit-identical.
    """
    N, Wy = Y_words.shape
    chunk = _GRAM_CHUNK
    from block_lanczos_tpu.ops.gfp import zeros_vma_like

    def chunk_gram_unrolled(Xc, Yc):
        rows = []
        for a in range(n_x):
            mask = bit_of(Xc, a)[:, None]
            rows.append(xor_reduce(mask & Yc, axis=0))
        return jnp.stack(rows)                       # (n_x, Wy)

    def chunk_gram_fused(Xc, Yc):
        # all n_x output rows in ONE masked XOR contraction: expand each X
        # word into 32 full masks and reduce the virtual (rows, n_x, Wy)
        # tensor over rows — XLA fuses the broadcasts into the reduction
        # (nothing is materialized); O(1) program size in n_x.
        c = Xc.shape[0]
        shifts = jnp.arange(WORD, dtype=u32)
        bits = (Xc[:, :, None] >> shifts[None, None, :]) & u32(1)
        mask = jnp.where(bits == 1, u32(0xFFFFFFFF),
                         u32(0)).reshape(c, n_x)
        return jax.lax.reduce(mask[:, :, None] & Yc[:, None, :], u32(0),
                              jax.lax.bitwise_xor, (0,))

    if n_x <= _GRAM_UNROLL:
        chunk_gram = chunk_gram_unrolled
    else:
        assert n_x % WORD == 0  # wide blocks are multiples of 32 by contract
        chunk_gram = chunk_gram_fused

    if N <= chunk:
        return chunk_gram(X_words, Y_words)
    pad = (-N) % chunk
    if pad:
        X_words = jnp.pad(X_words, ((0, pad), (0, 0)))
        Y_words = jnp.pad(Y_words, ((0, pad), (0, 0)))
    nchunks = (N + pad) // chunk

    def body(acc, xy):
        Xc, Yc = xy
        return acc ^ chunk_gram(Xc, Yc), None

    acc0 = zeros_vma_like((X_words, Y_words), (n_x, Wy))  # joined vma
    acc, _ = jax.lax.scan(
        body, acc0,
        (X_words.reshape(nchunks, chunk, -1),
         Y_words.reshape(nchunks, chunk, -1)))
    return acc


def _transpose32_blocks(a):
    """Transpose each trailing-(32,) group of words as a 32x32 bit matrix.

    The standard 5-stage masked shift-XOR butterfly (delta swaps at
    16/8/4/2/1), vectorized over leading axes: O(1) program size vs the
    per-bit unroll it replaces, which scaled the jaxpr with n.  Mirrored
    for the little-endian packing convention (bit c of a word = column c,
    pack_bits_np) — the textbook formulation assumes MSB-first rows.
    """
    shape = a.shape
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        m = u32(m)
        g = a.reshape(shape[:-1] + (WORD // (2 * j), 2, j))
        lo, hi = g[..., 0, :], g[..., 1, :]
        t = ((lo >> u32(j)) ^ hi) & m
        hi = hi ^ t
        lo = lo ^ (t << u32(j))
        a = jnp.stack([lo, hi], axis=-2).reshape(shape)
    return a


def transpose_bits(M_words, n: int):
    """(n, W) bit matrix -> its transpose as (n, W) words.

    Tiled into 32x32 bit blocks: butterfly-transpose every block, then swap
    the block grid.  Word-level throughout — no per-bit trace-time unroll.
    """
    W = words(n)
    blocks = M_words.reshape(W, WORD, W).transpose(0, 2, 1)  # [I, J, 32]
    tb = _transpose32_blocks(blocks)       # tb[I, J] = M block (I, J)^T
    # T block (I, J) = transpose of M block (J, I)
    return tb.transpose(1, 0, 2).transpose(0, 2, 1).reshape(n, W)


def semi_inverse_gf2(U_words, n: int):
    """(winv, d, npiv) over GF(2); same two-phase semantics as mod p.

    U_words: (n, W).  Returns winv (n, W) words, d (n,) 0/1, npiv int32.
    """
    W = words(n)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]

    def eliminate(M, Wv):
        def body(j, state):
            M, Wv, d, npiv = state
            w, b = j // WORD, j % WORD
            col = (M[:, w] >> jnp.uint32(b)) & u32(1)
            cand = (col == 1) & (rows >= j)
            found = jnp.any(cand)
            pivot = jnp.argmax(cand).astype(jnp.int32)

            perm = jnp.where(rows == j, pivot,
                             jnp.where(rows == pivot, j, rows))
            M2 = M[perm]
            W2 = Wv[perm]
            rowj_M = M2[j]
            rowj_W = W2[j]
            colj = (M2[:, w] >> jnp.uint32(b)) & u32(1)
            elim = ((colj == 1) & (rows != j))[:, None]
            M3 = jnp.where(elim, M2 ^ rowj_M[None, :], M2)
            W3 = jnp.where(elim, W2 ^ rowj_W[None, :], W2)

            M = jnp.where(found, M3, M)
            Wv = jnp.where(found, W3, Wv)
            d = d.at[j].set(found.astype(u32))
            npiv = npiv + found.astype(jnp.int32)
            return M, Wv, d, npiv

        # inits derived from M so their varying-manual-axes types match the
        # loop body outputs under shard_map (fresh zeros are "unvarying")
        zrow = M[:, 0] ^ M[:, 0]                  # (n,) zeros, M's vma
        d0 = zrow
        npiv0 = (M[0, 0] ^ M[0, 0]).astype(jnp.int32)
        return jax.lax.fori_loop(0, n, body, (M, Wv, d0, npiv0))

    scratch = U_words ^ U_words
    _, _, d1, _ = eliminate(U_words, scratch)

    # phase 2: re-eliminate on the d-masked matrix, tracking winv
    shifts = jnp.arange(WORD, dtype=u32)
    col_mask_words = (d1.reshape(W, WORD) << shifts).sum(
        axis=1, dtype=u32)                            # (W,) column mask by d
    M2 = jnp.where((d1 == 1)[:, None], U_words & col_mask_words[None, :],
                   u32(0))
    # identity * d as words: bit r of row r, if d[r]
    bitpos = (rows % WORD).astype(u32)
    wordpos = rows // WORD
    eye = jnp.zeros((n, W), u32)
    eye = eye.at[rows, wordpos].set(
        jnp.where(d1 == 1, u32(1) << bitpos, u32(0)))
    eye = eye ^ (U_words ^ U_words)   # inherit U's vma (shard_map)
    _, winv, d, npiv = eliminate(M2, eye)
    return winv, d, npiv


# ---------------------------------------------------------------------------
# Structured-instance preprocessing: m_eff-side dedup
# ---------------------------------------------------------------------------

def dedup_lines(i: np.ndarray, j: np.ndarray, nrows: int, ncols: int,
                right: bool):
    """Drop empty and duplicate m_eff-side lines from the GF(2) operator
    (columns for the left-kernel solve, rows for the right).

    Over GF(2) the Lanczos operator is A = sum_c c c^T over the m_eff-side
    lines c: a line appearing an EVEN number of times cancels out of A
    entirely, so duplicate-heavy structured instances (power-law relation
    matrices) silently shrink rank(A) below rank(M) and strand the terminal
    candidates in the large ker(M) /\\ im(M^T) obstruction space — the solve
    then ends with v != 0 but v^T M != 0 and nothing to salvage.  Keeping
    exactly ONE representative per distinct nonzero line is exact for the
    kernel (x^T M == 0 iff x is orthogonal to every distinct line) and
    restores rank(A) ~= rank(M), after which the standard combination
    (utils/salvage.py) recovers the residual few columns.  NFS pipelines
    apply the same filtering before Lanczos for the same reason.  The
    mod-p fields keep duplicates (no cancellation there; reference parity:
    sequential/lanczos_modp.c keeps the matrix verbatim).

    Lines are grouped by two independent 64-bit hash signatures plus the
    line weight; a false merge needs a 128-bit collision (~2^-128 per
    pair), and any such failure is caught downstream by the final check /
    independent checker.  Deterministic (fixed hash seed), so every host
    of a multi-process run computes the same filtered operator.

    Contract: compaction happens ONLY when duplicate lines exist.  Empty
    lines contribute nothing to A (c c^T = 0) and impose trivially
    satisfied constraints, so on duplicate-free instances — including
    instances whose only degeneracy is empty lines, and the all-empty
    operator — dedup is an exact passthrough (same arrays, reports
    (0, 0)) and the iterate stream stays bit-identical to the reference.
    When duplicates ARE dropped the stream already diverges, so empty
    lines are compacted away in the same pass (tighter iteration
    estimate, smaller final check).

    Returns (i, j, nrows_eff, ncols_eff, n_dup, n_empty) with the deduped
    side compacted in ascending original order (banding preserved);
    n_dup/n_empty report what was actually dropped.
    """
    lines = j if not right else i          # the m_eff side
    other = i if not right else j
    dim = ncols if not right else nrows
    odim = nrows if not right else ncols
    if len(lines) == 0:
        # all-empty operator: nothing cancels, exact passthrough
        return i, j, nrows, ncols, 0, 0
    rng = np.random.default_rng(0xB10C)
    h1 = rng.integers(1, 1 << 63, size=odim, dtype=np.int64).astype(np.uint64)
    h2 = rng.integers(1, 1 << 63, size=odim, dtype=np.int64).astype(np.uint64)
    order = np.argsort(lines, kind="stable")
    ls = lines[order]
    starts = np.flatnonzero(np.r_[True, ls[1:] != ls[:-1]])
    xor_sig = np.bitwise_xor.reduceat(h1[other[order]], starts)
    add_sig = np.add.reduceat(h2[other[order]], starts)   # u64 wrap is fine
    cnt = np.diff(np.r_[starts, len(ls)]).astype(np.uint64)
    line_ids = ls[starts]
    sig = np.stack([xor_sig, add_sig, cnt], axis=1)
    _, first = np.unique(sig, axis=0, return_index=True)
    keep_ids = np.sort(line_ids[first])
    n_empty = dim - len(line_ids)
    n_dup = len(line_ids) - len(keep_ids)
    if n_dup == 0:                         # duplicate-free: exact passthrough
        return i, j, nrows, ncols, 0, 0
    lut = np.full(dim, -1, np.int64)
    lut[keep_ids] = np.arange(len(keep_ids))
    m = lut[lines] >= 0
    new_lines = lut[lines[m]].astype(lines.dtype)
    new_other = other[m]
    dim_eff = len(keep_ids)
    if right:
        return new_lines, new_other, dim_eff, ncols, n_dup, n_empty
    return new_other, new_lines, nrows, dim_eff, n_dup, n_empty
