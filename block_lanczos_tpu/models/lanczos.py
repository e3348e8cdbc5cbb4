"""The block Lanczos solver (Thome's "fewer vectors" variant) on device.

Computes a block of kernel vectors of x*M == 0 (mod p) — or M*x == 0 with
right=True — reproducing the reference driver's semantics bit-for-bit
(reference: sequential/lanczos_modp.c:585-669):

    v0 <- xoshiro256+ fixed seed (row-major over nrows*n entries)
    loop:  tmp  = Mt*v ; Av = M*tmp            (A = M*Mt implicitly)
           vtAv = v^T*Av ; vtAAv = Av^T*Av
           winv, d <- semi_inverse(vtAv);  stop if 0 pivots
           v, p <- orthogonalize recurrence
    final_check: v != 0 and v^T*M == 0

Design decisions (vs the reference's root-centric imperative loop):
  * the ENTIRE iteration — two SpMVs, both Gram products, the semi-inverse,
    and the orthogonalize update — is one jitted function; the only
    device->host traffic per iteration is the stop flag (plus the n x n
    mats when invariant checking is on),
  * all state is functional (donated buffers, no aliasing dance with tmp),
  * padded shapes are static and zero-padded; zeros are preserved by every
    phase so padding never perturbs the math (mirrors the reference's
    block_size_pad zero-fill, sequential/lanczos_modp.c:594-622).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.ops import dense, gfp, spmm
from block_lanczos_tpu.ops.gfp import GFp, u32
from block_lanczos_tpu.ops.semi_inverse import semi_inverse_device
from block_lanczos_tpu.ops.spmm import SparseOp, SpMatrix
from block_lanczos_tpu.utils.mmio import COOMatrix
from block_lanczos_tpu.utils.rng import Xoshiro256Plus


def pad_rows(dim: int, multiple: int) -> int:
    return ((dim + multiple - 1) // multiple) * multiple


def fit_rows(arr, rows: int) -> np.ndarray:
    """Adapt a resume-state block's zero-padded row count to this solver's
    padding.  Mesh solvers pad the kernel dimension to band*R, single-device
    to a multiple of 8 — both paddings are all-zero rows, so a checkpoint
    written under one mesh shape resumes exactly under any other."""
    arr = np.asarray(arr)
    if arr.shape[0] == rows:
        return arr
    if arr.shape[0] > rows:
        if arr[rows:].any():
            raise ValueError(
                f"checkpoint block has {arr.shape[0]} rows with nonzero data "
                f"beyond this solver's padded size {rows} — wrong matrix or "
                "kernel side?")
        return np.ascontiguousarray(arr[:rows])
    pad = np.zeros((rows - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def state_rows(state: dict, name: str) -> np.ndarray:
    """A checkpoint block in TRUE row order.

    Skew-balanced mesh solvers store vector blocks in a permuted band
    layout and record the padded-position -> true-index map as `rowmap`
    in the snapshot (parallel/sharding.BandMap.rowmap).  Un-permute here
    so any solver — single-device, any mesh shape, any band layout — can
    resume from any checkpoint.  Without a rowmap the layout is the
    identity zero-padded one and the block passes through (fit_rows
    handles the trailing-zero trimming).
    """
    arr = np.asarray(state[name])
    rm = state.get("rowmap")
    if rm is None:
        return arr
    rm = np.asarray(rm)
    if rm.shape[0] != arr.shape[0]:
        raise ValueError(
            f"checkpoint rowmap covers {rm.shape[0]} rows but block "
            f"{name!r} has {arr.shape[0]}")
    dim = int(rm.max()) + 1
    out = np.zeros((dim,) + arr.shape[1:], arr.dtype)
    sel = rm >= 0
    out[rm[sel]] = arr[sel]
    return out


# ---------------------------------------------------------------------------
# Device-side phases
# ---------------------------------------------------------------------------

def orthogonalize_device(f: GFp, v, Av, p_blk, d, vtAv, vtAAv, winv):
    """One step of the Thome recurrence (reference: lanczos_modp.c:456-492).

    v, Av, p_blk: (Np, n); d: (n,) 0/1; the small mats: (n, n).
    Returns (v_next, p_next).  Zero padding rows stay zero.
    """
    n = d.shape[0]
    dmask = d.astype(bool)[None, :]          # column mask
    spliced = jnp.where(dmask, vtAAv, vtAv)
    c = gfp.modneg(f, dense.matmul_nn_mod(f, winv, spliced))
    vtAvd = jnp.where(dmask, gfp.modneg(f, vtAv), u32(0))

    # one fused (N, 2n) x (2n, 2n) pass computes v*c + p*vtAvd AND v*winv:
    #   [v | p] @ [[c, winv], [vtAvd, 0]] = [v*c + p*vtAvd | v*winv]
    rhs = jnp.block([[c, winv], [vtAvd, jnp.zeros((n, n), u32)]])
    upd = dense.matmul_mod(f, jnp.concatenate([v, p_blk], axis=1), rhs)

    v_next = gfp.modadd(f, jnp.where(dmask, Av, v), upd[:, :n])
    p_next = gfp.modadd(f, jnp.where(dmask, u32(0), p_blk), upd[:, n:])
    return v_next, p_next


def iteration_step(f: GFp, mp_rows: int, np_rows: int, check: bool,
                   first_op: SparseOp, second_op: SparseOp, v, p_blk):
    """One full Lanczos iteration on device.

    first_op:  v (Np) -> tmp (Mp)   [Mt for left kernel, M for right]
    second_op: tmp (Mp) -> Av (Np)
    Returns (v_next, p_next, tmp, Av, vtAv, vtAAv, winv, d, stop, inv_ok).

    The sparse ops are pytree ARGUMENTS, not closed-over constants: baking
    multi-MB arrays into the jitted executable as constants makes them part
    of the program; passing them keeps the buffers device-resident.
    """
    tmp = spmm.apply_op(f, first_op, v, out_rows=mp_rows)
    Av = spmm.apply_op(f, second_op, tmp, out_rows=np_rows)
    # both Gram products in ONE pass: [v | Av]^T * Av
    n = v.shape[1]
    grams = dense.gram_mod(f, jnp.concatenate([v, Av], axis=1), Av)
    vtAv, vtAAv = grams[:n], grams[n:]
    winv, d, npiv = semi_inverse_device(f, vtAv)
    stop = npiv == 0
    inv_ok = (check_invariants_device(f, vtAv, vtAAv, winv, d)
              if check else jnp.bool_(True))
    v_next, p_next = orthogonalize_device(f, v, Av, p_blk, d, vtAv, vtAAv, winv)
    # On stop the converged block is the PRE-update v (the reference breaks
    # before orthogonalize, lanczos_modp.c:649-652); selecting here keeps
    # the inputs donatable.
    v_out = jnp.where(stop, v, v_next)
    p_out = jnp.where(stop, p_blk, p_next)
    return v_out, p_out, tmp, Av, vtAv, vtAAv, winv, d, stop, inv_ok


def run_multi_step(step, zeros, v, p_blk, max_steps):
    """Up to `max_steps` Lanczos iterations in ONE device program.

    A host sync per iteration costs a full host<->device round trip, so the
    main loop runs as a lax.while_loop that exits early on convergence (or
    on a failed
    invariant) and returns how many iterations it completed.  `max_steps` is
    a traced scalar: the driver can clamp the last block for --stop-after
    without recompiling.

    step(v, p_blk) -> (v, p, tmp, *diag, stop, inv_ok); `zeros` supplies the
    zero-initialized (tmp, *diag) carry tail (sharded callers pcast these to
    the right varying-manual-axes types).  Returns (*step_out, k_done),
    where k_done INCLUDES the stopping probe iteration when stop is True
    (the reference does not count it, sequential/lanczos_modp.c:649-656 —
    blocked_solve_loop subtracts it).

    Shared by all six solvers (3 fields x {single device, mesh}).
    """
    init = (v, p_blk, *zeros, jnp.bool_(False), jnp.bool_(True),
            jnp.uint32(0))

    def cond(c):
        stop, inv_ok, k = c[-3], c[-2], c[-1]
        return (k < max_steps) & jnp.logical_not(stop) & inv_ok

    def body(c):
        out = step(c[0], c[1])
        return (*out, c[-1] + jnp.uint32(1))

    return jax.lax.while_loop(cond, body, init)


def multi_iteration_step(f: GFp, mp_rows: int, np_rows: int, check: bool,
                         first_op: SparseOp, second_op: SparseOp,
                         v, p_blk, max_steps):
    """Blocked narrow-field iteration; see run_multi_step."""
    n = v.shape[1]
    zed = jnp.zeros((n, n), u32)
    zeros = (jnp.zeros((mp_rows, n), u32), jnp.zeros((np_rows, n), u32),
             zed, zed, zed, jnp.zeros((n,), u32))
    return run_multi_step(
        lambda v, p: iteration_step(f, mp_rows, np_rows, check,
                                    first_op, second_op, v, p),
        zeros, v, p_blk, max_steps)


def check_invariants_device(f: GFp, vtAv, vtAAv, winv, d):
    """Per-iteration algebraic invariants, evaluated on device.

    Same checks as the reference's correctness_tests
    (sequential/lanczos_modp.c:532-557) but fused into the jitted step:
    symmetry of vtAv/vtAAv/winv, the support condition
    winv[i,j] != 0 => d_i or d_j, and winv * (vtAv*d) == diag(d).
    Returns a single replicated bool — no extra host traffic.
    """
    ok = jnp.all(vtAv == vtAv.T)
    ok &= jnp.all(vtAAv == vtAAv.T)
    ok &= jnp.all(winv == winv.T)
    db = d.astype(bool)
    ok &= jnp.all((winv == u32(0)) | db[:, None] | db[None, :])
    vtAvd = jnp.where(db[None, :], vtAv, u32(0))
    check = dense.matmul_nn_mod(f, winv, vtAvd)
    eye = jnp.eye(d.shape[0], dtype=bool)
    ok &= jnp.all(jnp.where(eye, check == d[None, :], check == u32(0)))
    return ok


# ---------------------------------------------------------------------------
# Host-side invariant checks (reference: lanczos_modp.c:532-582)
# ---------------------------------------------------------------------------

def check_invariants(p: int, vtAv, vtAAv, winv, d):
    """Per-iteration algebraic asserts ("disable in production")."""
    vtAv, vtAAv, winv, d = (np.asarray(a) for a in (vtAv, vtAAv, winv, d))
    assert (vtAv == vtAv.T).all(), "vtAv not symmetric"
    assert (vtAAv == vtAAv.T).all(), "vtAAv not symmetric"
    assert (winv == winv.T).all(), "winv not symmetric"
    dd = d.astype(bool)
    support_ok = (winv == 0) | dd[:, None] | dd[None, :]
    assert support_ok.all(), "winv support does not match d"
    vtAvd = np.where(dd[None, :], vtAv, 0).astype(np.uint32)
    check = gfp.np_matmul_mod(p, winv, vtAvd)
    assert (np.diag(check) == d).all() and \
        (check[~np.eye(len(d), dtype=bool)] == 0).all(), \
        "winv * (vtAv*d) != diag(d)"


def final_check(v, vtM, n_rows: int, m_rows: int, verbose: bool = True):
    """End-of-run self check: v != 0 and v^T*M == 0."""
    v = np.asarray(v)[:n_rows]
    vtM = np.asarray(vtM)[:m_rows]
    v_nonzero = bool((v != 0).any())
    product_zero = bool((vtM == 0).all())
    if verbose:
        print("Final check:")
        print(f"  - {'OK:    v != 0' if v_nonzero else 'KO:    v == 0'}")
        print(f"  - {'OK: vt*M == 0' if product_zero else 'KO: vt*M != 0'}")
    return v_nonzero, product_zero


# ---------------------------------------------------------------------------
# Solver driver
# ---------------------------------------------------------------------------

def blocked_solve_loop(multi_step, v, p_blk, start_iter: int,
                       stop_after: int, sync_every: int | None,
                       on_iteration=None, inv_fail=None, solver=None):
    """The shared driver loop: device-side iteration blocks + host sync.

    multi_step(v, p_blk, k) must return (v, p, tmp, *diag, stop, inv_ok,
    k_done); up to `sync_every` iterations run per dispatch (adaptive
    doubling 1 -> 1024 targeting ~0.25 s blocks when None).  On a failed
    invariant, inv_fail(diag, iteration) is called to raise with context.
    Returns (v, p_blk, tmp, n_iterations, stopped_by_limit, start_time).

    Callback cadence: `on_iteration` fires once per *device block* (after up
    to `sync_every` iterations, 1024 under the default adaptive mode), NOT
    once per Lanczos iteration.  Pass sync_every=1 for strict per-iteration
    callbacks at the cost of one host sync per iteration.
    """
    start = time.time()
    n_iterations = start_iter
    tmp = None
    stopped_by_limit = False
    block = sync_every or 1
    _ADAPT_CAP, _ADAPT_TARGET_S = 1024, 0.25
    # Multi-process: every process runs this loop around the SAME collective
    # program, so k_ask must be identical everywhere.  Wall-clock-based
    # doubling can race at the 0.25 s threshold (one process doubles, the
    # other doesn't -> mismatched while_loop trip counts -> the collectives
    # desynchronize and hang), so the ROOT's verdict is broadcast.
    import jax as _jax
    multiproc = _jax.process_count() > 1
    while True:
        remaining = (stop_after - n_iterations if stop_after > 0 else block)
        if remaining <= 0:
            stopped_by_limit = True
            break
        k_ask = min(block, remaining)
        t_blk = time.time()
        v, p_blk, tmp, *diag, stop, inv_ok, k_done = \
            multi_step(v, p_blk, k_ask)
        k_done = int(k_done)
        stop = bool(stop)
        if inv_fail is not None and not bool(inv_ok):
            inv_fail(diag, n_iterations + k_done)
            raise AssertionError("device invariant check failed")
        # the stopping probe iteration is not counted (the reference breaks
        # before incrementing, sequential/lanczos_modp.c:649-656)
        n_iterations += k_done - (1 if stop else 0)
        if on_iteration is not None:
            on_iteration(solver, n_iterations, v, p_blk, start)
        if stop:
            break
        if sync_every is None and block < _ADAPT_CAP:
            grow = time.time() - t_blk < _ADAPT_TARGET_S
            if multiproc:
                from jax.experimental import multihost_utils
                grow = bool(multihost_utils.broadcast_one_to_all(
                    np.asarray(grow)))
            if grow:
                block *= 2
    return v, p_blk, tmp, n_iterations, stopped_by_limit, start


@dataclasses.dataclass
class SolveResult:
    kernel: np.ndarray          # (N_eff, n) uint32 — the block of vectors
    iterations: int
    v_nonzero: bool | None      # final-check outcomes (None if stopped early)
    product_zero: bool | None
    elapsed: float
    stopped_by_limit: bool
    # v^T M (the last tmp), kept ONLY when the final check failed — input
    # for utils.salvage.salvage_kernel to recover the valid combinations
    vtM: np.ndarray | None = None


class BlockLanczos:
    """Single-device solver.  For multi-chip, see parallel.distributed."""

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 pad_multiple: int = 8, check_invariants: bool = True,
                 seed=None, layout: str = "hybrid",
                 sync_every: int | None = None, delta: bool = True):
        self.f = GFp.make(M.prime)
        self.n = int(n)
        self.right = bool(right)
        self.check_invariants = check_invariants
        self.sp = SpMatrix.from_coo(self.f, M, layout=layout, delta=delta,
                                    n=self.n)
        # effective dimensions: the kernel vector lives on N_eff
        self.n_eff = M.ncols if right else M.nrows
        self.m_eff = M.nrows if right else M.ncols
        self.first_op = self.sp.fwd if right else self.sp.bwd
        self.second_op = self.sp.bwd if right else self.sp.fwd
        self.np_rows = pad_rows(self.n_eff, pad_multiple)
        self.mp_rows = pad_rows(self.m_eff, pad_multiple)
        self.expected_iterations = 1 + self.m_eff // self.n
        self._rng = Xoshiro256Plus() if seed is None else Xoshiro256Plus(seed)

        step = jax.jit(
            partial(iteration_step, self.f, self.mp_rows, self.np_rows,
                    check_invariants),
            donate_argnums=(2, 3))
        self._step = lambda v, p_blk: step(self.first_op, self.second_op,
                                           v, p_blk)
        # sync_every: iterations per host sync.  None = adaptive (start at 1,
        # double until a block takes ~0.25 s wall); int = fixed.
        self.sync_every = sync_every
        multi = jax.jit(
            partial(multi_iteration_step, self.f, self.mp_rows, self.np_rows,
                    check_invariants),
            donate_argnums=(2, 3))
        self._multi_step = lambda v, p_blk, k: multi(
            self.first_op, self.second_op, v, p_blk, np.uint32(k))

    def initial_block(self) -> jnp.ndarray:
        """v0: xoshiro row-major over n_eff*n entries, zero-padded."""
        block = self._rng.fill_mod(self.n_eff * self.n, self.f.p)
        v0 = np.zeros((self.np_rows, self.n), np.uint32)
        v0[:self.n_eff] = block.reshape(self.n_eff, self.n)
        return jnp.asarray(v0)

    def solve(self, stop_after: int = -1, verbose: bool = False,
              on_iteration: Callable | None = None,
              resume_state: dict | None = None) -> SolveResult:
        """Run to convergence (or `stop_after` iterations).

        `on_iteration` fires once per device-side iteration block (adaptive,
        up to 1024 iterations per dispatch under the default sync_every=None),
        not once per Lanczos iteration; construct with sync_every=1 for strict
        per-iteration callbacks (see blocked_solve_loop).
        """
        f = self.f
        if resume_state is None:
            v = self.initial_block()
            p_blk = jnp.zeros((self.np_rows, self.n), u32)
            start_iter = 0
        else:
            v = jnp.asarray(fit_rows(state_rows(resume_state, "v"),
                                     self.np_rows))
            p_blk = jnp.asarray(fit_rows(state_rows(resume_state, "p"),
                                         self.np_rows))
            start_iter = int(resume_state["iteration"])
        if verbose:
            print("Block Lanczos")
            print(f"  - Expecting {self.expected_iterations} iterations")
            print("  - Main loop")

        def inv_fail(diag, iteration):
            # reproduce the precise failing assertion on host
            _Av, vtAv, vtAAv, winv, d = diag
            check_invariants(f.p, vtAv, vtAAv, winv, d)

        v, p_blk, tmp, n_iterations, stopped_by_limit, start = \
            blocked_solve_loop(
                self._multi_step, v, p_blk, start_iter, stop_after,
                self.sync_every, on_iteration=on_iteration,
                inv_fail=inv_fail if self.check_invariants else None,
                solver=self)
        elapsed = time.time() - start
        v_host = np.asarray(v)
        v_nonzero = product_zero = None
        vtM = None
        if not stopped_by_limit:
            v_nonzero, product_zero = final_check(
                v_host, tmp, self.n_eff, self.m_eff, verbose)
            if product_zero is False:
                vtM = np.asarray(tmp)[:self.m_eff]
        if verbose:
            print(f"  - Terminated in {elapsed:.1f}s after "
                  f"{n_iterations} iterations")
        return SolveResult(kernel=v_host[:self.n_eff],
                           iterations=n_iterations,
                           v_nonzero=v_nonzero, product_zero=product_zero,
                           elapsed=elapsed, stopped_by_limit=stopped_by_limit,
                           vtM=vtM)
