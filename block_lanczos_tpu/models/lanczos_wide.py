"""Block Lanczos for WIDE primes (2^30 - 35 < p < 2^62).

The reference rejects these primes outright (sequential/lanczos_modp.c:189-193);
this driver mirrors models/lanczos.py on the uint32-pair field of
ops/gfp_wide.py: same Thome recurrence, same fixed xoshiro v0 stream
(random64() % p — now retaining all 62 bits), same stop/final-check
semantics, same device-side multi-iteration loop.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.models.lanczos import (SolveResult, fit_rows,
                                               pad_rows, state_rows)
from block_lanczos_tpu.ops import gfp_wide as gw
from block_lanczos_tpu.ops import wide_ops as wo
from block_lanczos_tpu.ops.gfp import u32
from block_lanczos_tpu.ops.gfp_wide import GFpWide
from block_lanczos_tpu.utils.mmio import COOMatrix
from block_lanczos_tpu.utils.rng import Xoshiro256Plus


def orthogonalize_device(f: GFpWide, v, Av, p_blk, d, vtAv, vtAAv, winv):
    """Thome recurrence on (Np, n, 2) pair blocks (cf. lanczos.py)."""
    n = d.shape[0]
    dmask = d.astype(bool)[None, :, None]
    spliced = jnp.where(dmask, vtAAv, vtAv)
    c = gw.modneg(f, wo.matmul_mod(f, winv, spliced))
    vtAvd = jnp.where(dmask, gw.modneg(f, vtAv), u32(0))

    rhs = jnp.concatenate([
        jnp.concatenate([c, winv], axis=1),
        jnp.concatenate([vtAvd, jnp.zeros((n, n, 2), u32)], axis=1)], axis=0)
    upd = wo.matmul_mod(f, jnp.concatenate([v, p_blk], axis=1), rhs)

    v_next = gw.modadd(f, jnp.where(dmask, Av, v), upd[:, :n])
    p_next = gw.modadd(f, jnp.where(dmask, u32(0), p_blk), upd[:, n:])
    return v_next, p_next


def check_invariants_device(f: GFpWide, vtAv, vtAAv, winv, d):
    ok = jnp.all(vtAv == jnp.swapaxes(vtAv, 0, 1))
    ok &= jnp.all(vtAAv == jnp.swapaxes(vtAAv, 0, 1))
    ok &= jnp.all(winv == jnp.swapaxes(winv, 0, 1))
    db = d.astype(bool)
    wz = (winv[..., 0] == 0) & (winv[..., 1] == 0)
    ok &= jnp.all(wz | db[:, None] | db[None, :])
    vtAvd = jnp.where(db[None, :, None], vtAv, u32(0))
    check = wo.matmul_mod(f, winv, vtAvd)
    eye = jnp.eye(d.shape[0], dtype=bool)
    diag_ok = (check[..., 0] == d[None, :]) & (check[..., 1] == 0)
    off_ok = (check[..., 0] == 0) & (check[..., 1] == 0)
    ok &= jnp.all(jnp.where(eye, diag_ok, off_ok))
    return ok


def iteration_step(f: GFpWide, mp_rows: int, np_rows: int, check: bool,
                   first_op, second_op, v, p_blk):
    tmp = wo.apply_wide(f, first_op, v, out_rows=mp_rows)
    Av = wo.apply_wide(f, second_op, tmp, out_rows=np_rows)
    n = v.shape[1]
    grams = wo.gram_mod(f, jnp.concatenate([v, Av], axis=1), Av)
    vtAv, vtAAv = grams[:n], grams[n:]
    winv, d, npiv = wo.semi_inverse_device(f, vtAv)
    stop = npiv == 0
    inv_ok = (check_invariants_device(f, vtAv, vtAAv, winv, d)
              if check else jnp.bool_(True))
    v_next, p_next = orthogonalize_device(f, v, Av, p_blk, d, vtAv, vtAAv, winv)
    v_out = jnp.where(stop, v, v_next)
    p_out = jnp.where(stop, p_blk, p_next)
    return v_out, p_out, tmp, Av, vtAv, vtAAv, winv, d, stop, inv_ok


def multi_iteration_step(f: GFpWide, mp_rows: int, np_rows: int, check: bool,
                         first_op, second_op, v, p_blk, max_steps):
    from block_lanczos_tpu.models.lanczos import run_multi_step
    n = v.shape[1]
    zed = jnp.zeros((n, n, 2), u32)
    zeros = (jnp.zeros((mp_rows, n, 2), u32),
             jnp.zeros((np_rows, n, 2), u32), zed, zed, zed,
             jnp.zeros((n,), u32))
    return run_multi_step(
        lambda v, p: iteration_step(f, mp_rows, np_rows, check,
                                    first_op, second_op, v, p),
        zeros, v, p_blk, max_steps)


def final_check(v_pairs, vtM_pairs, n_rows: int, m_rows: int,
                verbose: bool = True):
    v = np.asarray(v_pairs)[:n_rows]
    vtM = np.asarray(vtM_pairs)[:m_rows]
    v_nonzero = bool((v != 0).any())
    product_zero = bool((vtM == 0).all())
    if verbose:
        print("Final check:")
        print(f"  - {'OK:    v != 0' if v_nonzero else 'KO:    v == 0'}")
        print(f"  - {'OK: vt*M == 0' if product_zero else 'KO: vt*M != 0'}")
    return v_nonzero, product_zero


class BlockLanczosWide:
    """Single-device solver for wide primes; API mirrors BlockLanczos."""

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 pad_multiple: int = 8, check_invariants: bool = True,
                 seed=None, sync_every: int | None = None):
        self.f = GFpWide.make(M.prime)
        self.n = int(n)
        self.right = bool(right)
        self.check_invariants = check_invariants
        x_obj = np.asarray(M.x, dtype=object)
        # input banding engages per direction when the (in_dim, n) PAIR
        # gather table exceeds the banding threshold — the wide twin of
        # SpMatrix.from_coo's policy (ops/spmm.py:160-170)
        fwd = wo.make_wide_op_auto(self.f, M.i, M.j, x_obj,
                                   M.nrows, M.ncols, n=self.n)
        bwd = wo.make_wide_op_auto(self.f, M.j, M.i, x_obj,
                                   M.ncols, M.nrows, n=self.n)
        self.nnz = M.nnz
        self.n_eff = M.ncols if right else M.nrows
        self.m_eff = M.nrows if right else M.ncols
        self.first_op = fwd if right else bwd
        self.second_op = bwd if right else fwd
        self.np_rows = pad_rows(self.n_eff, pad_multiple)
        self.mp_rows = pad_rows(self.m_eff, pad_multiple)
        self.expected_iterations = 1 + self.m_eff // self.n
        self._rng = Xoshiro256Plus() if seed is None else Xoshiro256Plus(seed)
        self.sync_every = sync_every

        step = jax.jit(partial(iteration_step, self.f, self.mp_rows,
                               self.np_rows, check_invariants),
                       donate_argnums=(2, 3))
        self._step = lambda v, p_blk: step(self.first_op, self.second_op,
                                           v, p_blk)
        multi = jax.jit(partial(multi_iteration_step, self.f, self.mp_rows,
                                self.np_rows, check_invariants),
                        donate_argnums=(2, 3))
        self._multi_step = lambda v, p_blk, k: multi(
            self.first_op, self.second_op, v, p_blk, np.uint32(k))

    def initial_block(self):
        """v0: xoshiro random64() % p, row-major — full 62-bit values."""
        block = self._rng.fill_mod64(self.n_eff * self.n, self.f.p)
        v0 = np.zeros((self.np_rows, self.n), np.uint64)
        v0[:self.n_eff] = block.reshape(self.n_eff, self.n)
        return jnp.asarray(gw.np_pair(v0.astype(object)))

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
            p_blk = jnp.zeros((self.np_rows, self.n, 2), u32)
            n_iterations = 0
        else:
            v = jnp.asarray(fit_rows(state_rows(resume_state, "v"),
                                     self.np_rows))
            p_blk = jnp.asarray(fit_rows(state_rows(resume_state, "p"),
                                         self.np_rows))
            n_iterations = int(resume_state["iteration"])
        if verbose:
            print("Block Lanczos [wide field]")
            print(f"  - Expecting {self.expected_iterations} iterations")
            print("  - Main loop")

        def inv_fail(diag, iteration):
            raise AssertionError(
                f"device invariant check failed (wide field) at iteration "
                f"~{iteration}")

        from block_lanczos_tpu.models.lanczos import blocked_solve_loop
        v, p_blk, tmp, n_iterations, stopped_by_limit, start = \
            blocked_solve_loop(
                self._multi_step, v, p_blk, n_iterations, stop_after,
                self.sync_every, on_iteration=on_iteration,
                inv_fail=inv_fail if self.check_invariants else None,
                solver=self)
        elapsed = time.time() - start
        v_host64 = np.asarray(gw.np_unpair(np.asarray(v))).astype(np.uint64)
        v_nonzero = product_zero = None
        vtM = None
        if not stopped_by_limit:
            tmp_host = gw.np_unpair(np.asarray(tmp))
            v_nonzero, product_zero = final_check(
                v_host64, tmp_host, self.n_eff, self.m_eff, verbose)
            if product_zero is False:
                vtM = np.asarray(tmp_host[:self.m_eff], dtype=np.uint64)
        if verbose:
            print(f"  - Terminated in {elapsed:.1f}s after "
                  f"{n_iterations} iterations")
        return SolveResult(kernel=v_host64[:self.n_eff],
                           iterations=n_iterations,
                           v_nonzero=v_nonzero, product_zero=product_zero,
                           elapsed=elapsed, stopped_by_limit=stopped_by_limit,
                           vtM=vtM)
