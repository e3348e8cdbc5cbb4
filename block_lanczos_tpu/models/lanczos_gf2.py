"""Bitsliced block Lanczos over GF(2) — the integer-factorization case.

Mirrors models/lanczos.py with the bit-packed representation of ops/gf2.py:
a block of n vectors (n % 32 == 0) is (N, n/32) uint32 words; the SpMV
streams only column indices (~4x fewer bytes per iteration than the
generic mod-p path) and every reduction is XOR.  Iterates are bit-identical
to the generic solver at p=2 for the same n (same xoshiro v0 stream; tested).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.models.lanczos import (SolveResult, fit_rows,
                                               pad_rows, state_rows)
from block_lanczos_tpu.ops import gf2
from block_lanczos_tpu.ops.gf2 import WORD, words
from block_lanczos_tpu.ops.gfp import u32
from block_lanczos_tpu.utils.mmio import COOMatrix
from block_lanczos_tpu.utils.rng import Xoshiro256Plus


# ---------------------------------------------------------------------------
# Sparse operator: ELL slab of column indices + XOR-prefix spill
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GF2Op:
    """y[r] = XOR over k of (valid[r,k] ? x[cols[r, k]] : 0).

    `valid` is bit-packed: bit k%32 of valid[r, k//32] marks slot (r, k)
    as a real entry; padding slots contribute nothing, so x needs no
    sentinel zero row (works with fully-populated shards under shard_map).
    """
    out_dim: int
    in_dim: int
    nnz: int
    ell: int
    cols: jax.Array      # (out_pad, L) int32; padding slots -> 0
    valid: jax.Array     # (out_pad, ceil(L/32)) uint32 bit-mask
    spill_out: jax.Array
    spill_in: jax.Array
    spill_rowptr: jax.Array
    spill_nnz: int

    def tree_flatten(self):
        return ((self.cols, self.valid, self.spill_out, self.spill_in,
                 self.spill_rowptr),
                (self.out_dim, self.in_dim, self.nnz, self.ell,
                 self.spill_nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, valid, s_o, s_i, s_rp = children
        out_dim, in_dim, nnz, ell, s_nnz = aux
        return cls(out_dim, in_dim, nnz, ell, cols, valid,
                   s_o, s_i, s_rp, s_nnz)


def build_gf2_arrays(out_idx, in_idx, out_dim: int,
                     ell: int | None = None, spill_pad_to: int | None = None):
    """Host-side slab/valid/spill construction (NumPy arrays)."""
    from block_lanczos_tpu.ops.spmm import (_within_row_positions,
                                            choose_ell_width)
    out_idx = np.asarray(out_idx, np.int64)
    in_idx = np.asarray(in_idx, np.int64)
    order = np.argsort(out_idx, kind="stable")
    out_idx, in_idx = out_idx[order], in_idx[order]
    nnz = len(out_idx)
    counts = (np.bincount(out_idx, minlength=out_dim) if nnz
              else np.zeros(out_dim, np.int64))
    if ell is None:
        ell = choose_ell_width(counts)
    pos = _within_row_positions(out_idx)
    in_slab = pos < ell
    flat = (out_idx * ell + pos)[in_slab]
    cols2d = np.zeros(out_dim * ell, np.int32)
    cols2d[flat] = in_idx[in_slab]
    cols2d = cols2d.reshape(out_dim, ell)
    vwords = (ell + WORD - 1) // WORD
    valid = np.zeros((out_dim, vwords * WORD), np.uint32)
    valid.reshape(-1)[(out_idx * (vwords * WORD) + pos)[in_slab]] = 1
    valid = gf2.pack_bits_np(valid)

    sp = ~in_slab
    s_out = out_idx[sp].astype(np.int32)
    s_in = in_idx[sp].astype(np.int32)
    rowptr = np.searchsorted(s_out, np.arange(out_dim + 1)).astype(np.int32)
    s_nnz = len(s_out)
    target = max(s_nnz, spill_pad_to or 0, 1)
    pad = target - s_nnz
    if pad:
        # padding lives past rowptr[out_dim] (= s_nnz), so the prefix
        # differences never select it; values are irrelevant
        s_out = np.concatenate([s_out, np.full(pad, out_dim - 1, np.int32)])
        s_in = np.concatenate([s_in, np.zeros(pad, np.int32)])
    return cols2d, valid, (s_out, s_in, s_nnz, rowptr), nnz, int(ell)


def make_gf2_op(out_idx, in_idx, out_dim: int, in_dim: int,
                ell: int | None = None) -> GF2Op:
    """Entries must already be reduced mod 2 and filtered to odd values."""
    cols2d, valid, (s_out, s_in, s_nnz, rowptr), nnz, ell = \
        build_gf2_arrays(out_idx, in_idx, out_dim, ell=ell)
    return GF2Op(out_dim=out_dim, in_dim=in_dim, nnz=nnz, ell=ell,
                 cols=jnp.asarray(cols2d), valid=jnp.asarray(valid),
                 spill_out=jnp.asarray(s_out),
                 spill_in=jnp.asarray(s_in), spill_rowptr=jnp.asarray(rowptr),
                 spill_nnz=s_nnz)


# slab-walk unroll limit, as ops/spmm.py (set before the H100 port;
# not measured on the H100, ROADMAP C5)
_ELL_UNROLL = 32


def spmv_gf2(op: GF2Op, x_words, out_rows: int):
    """y = op * x over GF(2); x_words (in_pad, W), in_pad >= in_dim.
    Returns (out_rows, W); rows past out_dim are zero."""
    W = x_words.shape[1]
    out_pad = op.cols.shape[0]

    def step(k_static, y, ck):
        mask = gf2.bit_of(op.valid, k_static)[:, None]
        return y ^ (mask & x_words[ck])

    def slab_step(k, y):
        ck = jax.lax.dynamic_index_in_dim(op.cols, k, 1, keepdims=False)
        w = k // WORD
        vw = jax.lax.dynamic_index_in_dim(op.valid, w, 1, keepdims=False)
        bit = (vw >> (k % WORD).astype(jnp.uint32)) & u32(1)
        mask = jnp.where(bit == 1, u32(0xFFFFFFFF), u32(0))[:, None]
        return y ^ (mask & x_words[ck])

    from block_lanczos_tpu.ops.gfp import zeros_vma_like
    # fori carry: join of x's and the slab leaves' vma
    y = zeros_vma_like((x_words, op.valid), (out_pad, W))
    if op.ell <= _ELL_UNROLL:
        for k in range(op.ell):
            y = step(k, y, op.cols[:, k])
    else:
        y = jax.lax.fori_loop(0, op.ell, slab_step, y)

    if op.spill_nnz:
        g = x_words[op.spill_in]                       # (s_nnz_pad, W)
        pref = jax.lax.associative_scan(jnp.bitwise_xor, g, axis=0)
        pref = jnp.concatenate([jnp.zeros((1, W), u32), pref])
        seg = pref[op.spill_rowptr[1:]] ^ pref[op.spill_rowptr[:-1]]
        y = y ^ seg

    if out_rows > out_pad:
        y = jnp.pad(y, ((0, out_rows - out_pad), (0, 0)))
    elif out_rows < out_pad:
        y = y[:out_rows]
    return y


# ---------------------------------------------------------------------------
# Iteration
# ---------------------------------------------------------------------------

def _colmask(d):
    """(n,) 0/1 -> (W,) words with bit c set iff d[c]."""
    W = d.shape[0] // WORD
    shifts = jnp.arange(WORD, dtype=u32)
    return (d.astype(u32).reshape(W, WORD) << shifts).sum(axis=1, dtype=u32)


def orthogonalize_gf2(v, Av, p_blk, d, vtAv, vtAAv, winv, n: int):
    W = words(n)
    cm = _colmask(d)[None, :]                     # (1, W)
    spliced = (vtAAv & cm) | (vtAv & ~cm)
    c = gf2.matmul_gf2(winv, spliced, n)          # (n, W); no negation in GF2
    vtAvd = vtAv & cm

    rhs = jnp.concatenate([
        jnp.concatenate([c, winv], axis=1),
        jnp.concatenate([vtAvd, jnp.zeros((n, W), u32)], axis=1)], axis=0)
    upd = gf2.matmul_gf2(jnp.concatenate([v, p_blk], axis=1), rhs, 2 * n)

    v_next = ((Av & cm) | (v & ~cm)) ^ upd[:, :W]
    p_next = (p_blk & ~cm) ^ upd[:, W:]
    return v_next, p_next


def check_invariants_gf2(vtAv, vtAAv, winv, d, n: int):
    ok = jnp.all(vtAv == gf2.transpose_bits(vtAv, n))
    ok &= jnp.all(vtAAv == gf2.transpose_bits(vtAAv, n))
    ok &= jnp.all(winv == gf2.transpose_bits(winv, n))
    # support: winv[i, j] != 0 => d_i or d_j.  Rows with d_i = 1 pass
    # trivially; rows with d_i = 0 must vanish outside the d columns.
    cm = _colmask(d)[None, :]
    db = d.astype(bool)
    ok &= jnp.all(jnp.where(db[:, None], jnp.bool_(True),
                            (winv & ~cm) == u32(0)))
    vtAvd = vtAv & cm
    check = gf2.matmul_gf2(winv, vtAvd, n)        # (n, W)
    # expected: diag(d)
    rows = jnp.arange(n)
    eye = jnp.zeros((n, words(n)), u32).at[rows, rows // WORD].set(
        jnp.where(d == 1, u32(1) << (rows % WORD).astype(u32), u32(0)))
    ok &= jnp.all(check == eye)
    return ok


def iteration_step(first_op: GF2Op, second_op: GF2Op, n: int,
                   mp_rows: int, np_rows: int, check: bool, v, p_blk):
    tmp = spmv_gf2(first_op, v, out_rows=mp_rows)
    Av = spmv_gf2(second_op, tmp, out_rows=np_rows)
    grams = gf2.gram_gf2(jnp.concatenate([v, Av], axis=1), Av, 2 * n)
    vtAv, vtAAv = grams[:n], grams[n:]
    winv, d, npiv = gf2.semi_inverse_gf2(vtAv, n)
    stop = npiv == 0
    inv_ok = (check_invariants_gf2(vtAv, vtAAv, winv, d, n)
              if check else jnp.bool_(True))
    v_next, p_next = orthogonalize_gf2(v, Av, p_blk, d, vtAv, vtAAv, winv, n)
    v_out = jnp.where(stop, v, v_next)
    p_out = jnp.where(stop, p_blk, p_next)
    return v_out, p_out, tmp, Av, vtAv, vtAAv, winv, d, stop, inv_ok


def multi_iteration_step(first_op: GF2Op, second_op: GF2Op, n: int,
                         mp_rows: int, np_rows: int, check: bool,
                         v, p_blk, max_steps):
    from block_lanczos_tpu.models.lanczos import run_multi_step
    W = words(n)
    zed = jnp.zeros((n, W), u32)
    zeros = (jnp.zeros((mp_rows, W), u32), jnp.zeros((np_rows, W), u32),
             zed, zed, zed, jnp.zeros((n,), u32))
    return run_multi_step(
        lambda v, p: iteration_step(first_op, second_op, n, mp_rows,
                                    np_rows, check, v, p),
        zeros, v, p_blk, max_steps)


class BlockLanczosGF2:
    """Single-device bitsliced GF(2) solver; API mirrors BlockLanczos.

    Requires n % 32 == 0.  Entries that are even (0 mod 2) are dropped at
    construction; remaining entries all equal 1.
    """

    def __init__(self, M: COOMatrix, n: int = 32, right: bool = False,
                 pad_multiple: int = 8, check_invariants: bool = True,
                 seed=None, sync_every: int | None = None,
                 dedup: bool = True):
        if int(M.prime) != 2:
            raise ValueError("BlockLanczosGF2 requires p == 2")
        if n % WORD != 0:
            raise ValueError("bitsliced GF(2) requires n % 32 == 0")
        self.n = int(n)
        self.W = words(self.n)
        self.right = bool(right)
        self.check_invariants = check_invariants
        odd = (np.asarray(M.x) & 1) == 1
        i, j = M.i[odd], M.j[odd]
        # m_eff-side dedup: duplicate lines cancel out of A = M M^T over
        # GF(2) and break structured instances (see gf2.dedup_lines);
        # dedup=False keeps bit-parity with the generic p=2 solver on
        # duplicate-line instances (it is a no-op on distinct-line ones)
        if dedup:
            i, j, nrows_eff, ncols_eff, n_dup, n_empty = gf2.dedup_lines(
                i, j, M.nrows, M.ncols, right)
        else:
            nrows_eff, ncols_eff, n_dup, n_empty = (M.nrows, M.ncols, 0, 0)
        self.dedup_dropped = (n_dup, n_empty)
        self.nnz = len(i)
        self.n_eff = ncols_eff if right else nrows_eff
        self.m_eff = nrows_eff if right else ncols_eff
        self.np_rows = pad_rows(self.n_eff, pad_multiple)
        self.mp_rows = pad_rows(self.m_eff, pad_multiple)
        fwd = make_gf2_op(i, j, nrows_eff, ncols_eff)
        bwd = make_gf2_op(j, i, ncols_eff, nrows_eff)
        self.first_op = fwd if right else bwd
        self.second_op = bwd if right else fwd
        self.expected_iterations = 1 + self.m_eff // self.n
        self._rng = Xoshiro256Plus() if seed is None else Xoshiro256Plus(seed)
        self.sync_every = sync_every

        multi = jax.jit(partial(multi_iteration_step), static_argnums=(2, 3, 4, 5),
                        donate_argnums=(6, 7))
        self._multi_step = lambda v, p_blk, k: multi(
            self.first_op, self.second_op, self.n, self.mp_rows,
            self.np_rows, self.check_invariants, v, p_blk, np.uint32(k))

    def initial_block(self):
        """v0 bits from the same xoshiro stream: random64() % 2 per entry."""
        bits = self._rng.fill_mod(self.n_eff * self.n, 2)
        block = np.zeros((self.np_rows, self.n), np.uint32)
        block[:self.n_eff] = bits.reshape(self.n_eff, self.n)
        return jnp.asarray(gf2.pack_bits_np(block))

    def solve(self, stop_after: int = -1, verbose: bool = False,
              on_iteration: Callable | None = None,
              resume_state: dict | None = None) -> SolveResult:
        """Run to convergence (or `stop_after` iterations).

        `on_iteration` fires once per device-side iteration block (adaptive,
        up to 1024 iterations per dispatch under the default sync_every=None),
        not once per Lanczos iteration; construct with sync_every=1 for strict
        per-iteration callbacks (see lanczos.blocked_solve_loop).
        """
        if resume_state is None:
            v = self.initial_block()
            p_blk = jnp.zeros((self.np_rows, self.W), u32)
            n_iterations = 0
        else:
            v = jnp.asarray(fit_rows(state_rows(resume_state, "v"),
                                     self.np_rows))
            p_blk = jnp.asarray(fit_rows(state_rows(resume_state, "p"),
                                         self.np_rows))
            n_iterations = int(resume_state["iteration"])
        if verbose:
            print("Block Lanczos [GF(2) bitsliced]")
            if any(self.dedup_dropped):
                nd, ne = self.dedup_dropped
                print(f"  - GF(2) dedup: dropped {nd} duplicate + {ne} "
                      "empty lines (operator rank restoration)")
            print(f"  - Expecting {self.expected_iterations} iterations")
            print("  - Main loop")

        def inv_fail(diag, iteration):
            raise AssertionError(
                f"device invariant check failed (GF2) at iteration "
                f"~{iteration}")

        from block_lanczos_tpu.models.lanczos import blocked_solve_loop
        v, p_blk, tmp, n_iterations, stopped_by_limit, start = \
            blocked_solve_loop(
                self._multi_step, v, p_blk, n_iterations, stop_after,
                self.sync_every, on_iteration=on_iteration,
                inv_fail=inv_fail if self.check_invariants else None,
                solver=self)
        elapsed = time.time() - start
        v_bits = gf2.unpack_bits_np(np.asarray(v), self.n)
        v_nonzero = product_zero = None
        vtM = None
        if not stopped_by_limit:
            tmp_bits = gf2.unpack_bits_np(np.asarray(tmp), self.n)
            v_nonzero = bool((v_bits[:self.n_eff] != 0).any())
            product_zero = bool((tmp_bits[:self.m_eff] == 0).all())
            if not product_zero:
                vtM = tmp_bits[:self.m_eff]
            if verbose:
                print("Final check:")
                print(f"  - {'OK:    v != 0' if v_nonzero else 'KO:    v == 0'}")
                print(f"  - {'OK: vt*M == 0' if product_zero else 'KO: vt*M != 0'}")
        if verbose:
            print(f"  - Terminated in {elapsed:.1f}s after "
                  f"{n_iterations} iterations")
        return SolveResult(kernel=v_bits[:self.n_eff],
                           iterations=n_iterations,
                           v_nonzero=v_nonzero, product_zero=product_zero,
                           elapsed=elapsed, stopped_by_limit=stopped_by_limit,
                           vtM=vtM)
