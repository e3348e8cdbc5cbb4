"""Profiling / observability helpers.

The reference's performance story is offline gprof/perf (SURVEY.md section 5,
"Tracing / profiling: none in-code") plus the verbosity engine's s/iter.
Here profiling is first-class:

  * `phase_timers(solver)` — per-phase wall times (SpMV / Gram /
    semi-inverse / orthogonalize) measured with real device sync, plus
    derived nnz/s — the analogue of the reference's 62/24/14% hotspot
    split (BASELINE.md).
  * `trace(path)` — context manager around jax.profiler for XLA-level
    traces viewable in TensorBoard/Perfetto.
  * `solver_loop(solver)` + `loop_s_per_iter(...)` — steady s/iteration
    of a solver's own device-side loop (what bench.py and chip_smoke.py
    report), without the solve's host set-up and final check;
    `compile_loop(solver)` compiles that loop ahead of time (compile
    seconds, `memory_analysis()`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

import jax
import jax.numpy as jnp

from block_lanczos_tpu.ops import dense, spmm
from block_lanczos_tpu.ops.semi_inverse import semi_inverse_device


@contextlib.contextmanager
def trace(path: str):
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def solver_loop(solver):
    """(run, v, p) for the solver's device-side iteration loop from a fresh
    v0: run(v, p, k) dispatches up to k iterations as one program and
    returns (v, p, ..., k_done).  Single-device and mesh solvers alike;
    the loop donates v and p, so feed each call the previous outputs."""
    v = solver.initial_block()
    if hasattr(solver, "_step_args"):   # mesh solvers: operator as args
        from block_lanczos_tpu.parallel.multihost import put_global
        args = solver._step_args()
        p = put_global(np.zeros(v.shape, v.dtype), solver._vec_sharding)
        return (lambda v, p, k: solver._multi_step(*args, v, p,
                                                   np.uint32(k))), v, p
    return solver._multi_step, v, jnp.zeros_like(v)


def compile_loop(solver):
    """AOT-compile a mesh solver's device loop, the program that solve()
    and solver_loop dispatch, without running it: (compiled, seconds).
    The persistent compile cache then serves the solver's own first
    dispatch.  Draws one v0 from the solver's stream for the shapes."""
    _run, v, p = solver_loop(solver)
    t0 = time.perf_counter()
    compiled = solver._multi_step.lower(*solver._step_args(), v, p,
                                        np.uint32(1)).compile()
    return compiled, time.perf_counter() - t0


def loop_s_per_iter(run, v, p, iters: int, warmup: int = 4):
    """Steady seconds per iteration of a device loop `run` (see
    solver_loop): one dispatch of `warmup` iterations compiles and warms,
    then one dispatch of `iters`, continuing from where the warm-up
    stopped, is timed.  Returns (s/iteration, iterations it ran), which
    is fewer than `iters` when the solve converges inside the window."""
    v, p, *_ = jax.block_until_ready(run(v, p, warmup))
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(v, p, iters))
    done = int(out[-1])
    return (time.perf_counter() - t0) / max(done, 1), done


def _timed(fn, *args, iters: int = 5):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def ablation_timers(solver, iters: int = 50, runs: int = 2) -> dict:
    """Accurate in-loop phase attribution for a BlockLanczos solver.

    phase_timers times each phase as a standalone jit, which loses the
    fusion (and dispatch amortization) of the real iteration loop — ~3x
    pessimistic in practice.  This instead times the FULL device-side loop
    with one phase at a time replaced by a cheap shape-preserving stand-in;
    the phase's true in-context cost is the delta vs the full loop.
    """
    from block_lanczos_tpu.models.lanczos import orthogonalize_device
    from block_lanczos_tpu.ops.gfp import u32

    f = solver.f
    first_op, second_op = solver.first_op, solver.second_op
    mp_rows, np_rows = solver.mp_rows, solver.np_rows

    def make_loop(disabled: str | None):
        def body(c):
            v, p_blk, k = c
            n = v.shape[1]
            if disabled == "spmv1":
                tmp = jnp.pad(v, ((0, max(mp_rows - v.shape[0], 0)), (0, 0))
                              )[:mp_rows]
            else:
                tmp = spmm.apply_op(f, first_op, v, out_rows=mp_rows)
            if disabled == "spmv2":
                Av = jnp.pad(tmp, ((0, max(np_rows - mp_rows, 0)), (0, 0))
                             )[:np_rows]
            else:
                Av = spmm.apply_op(f, second_op, tmp, out_rows=np_rows)
            if disabled == "gram":
                vtAv = (v[:n] + Av[:n]) % u32(f.p)
                vtAAv = vtAv
            else:
                grams = dense.gram_mod(f, jnp.concatenate([v, Av], axis=1),
                                       Av)
                vtAv, vtAAv = grams[:n], grams[n:]
            if disabled == "semi":
                winv, d = vtAv, jnp.ones((n,), u32)
            else:
                winv, d, _ = semi_inverse_device(f, vtAv)
            if disabled == "orth":
                from block_lanczos_tpu.ops import gfp
                v_next = gfp.modadd(f, Av, v)
                p_next = gfp.modadd(f, p_blk, v)
            else:
                v_next, p_next = orthogonalize_device(
                    f, v, Av, p_blk, d, vtAv, vtAAv, winv)
            return (v_next, p_next, k + jnp.uint32(1))

        def cond(c):
            return c[-1] < jnp.uint32(iters)

        @jax.jit
        def run(v, p_blk):
            return jax.lax.while_loop(cond, body,
                                      (v, p_blk, jnp.uint32(0)))
        return run

    def timed_loop(disabled):
        run = make_loop(disabled)
        v = solver.initial_block()
        p = jnp.zeros_like(v)
        jax.block_until_ready(run(v, p))  # compile + warm
        best = float("inf")
        for _ in range(max(runs, 1)):  # min over runs: dispatch jitter
            v = solver.initial_block()
            p = jnp.zeros_like(v)
            t0 = time.perf_counter()
            jax.block_until_ready(run(v, p))
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    full = timed_loop(None)
    report = {"full_iteration_s": full}
    for ph in ["spmv1", "spmv2", "gram", "semi", "orth"]:
        report[f"{ph}_s"] = max(full - timed_loop(ph), 0.0)
    nnz = solver.sp.nnz if hasattr(solver, "sp") else None
    if nnz:
        report["spmv_nnz_per_s"] = 2 * nnz / max(
            report["spmv1_s"] + report["spmv2_s"], 1e-12)
        report["iteration_nnz_per_s"] = 2 * nnz / full
    return report


def phase_timers(solver, iters: int = 5) -> dict:
    """Per-phase timings for a BlockLanczos solver instance.

    Caveat: each phase is timed as a standalone jit — useful for relative
    comparisons, but ~3x pessimistic vs the fused iteration loop.  Use
    ablation_timers for accurate in-context attribution.
    """
    f = solver.f
    v = solver.initial_block()

    # ops passed as pytree args (closed-over arrays become executable
    # constants that get re-materialized per call — see models/lanczos.py)
    spmv1 = jax.jit(lambda op, v: spmm.apply_op(
        f, op, v, out_rows=solver.mp_rows))
    t_spmv1, tmp = _timed(spmv1, solver.first_op, v, iters=iters)
    spmv2 = jax.jit(lambda op, t: spmm.apply_op(
        f, op, t, out_rows=solver.np_rows))
    t_spmv2, Av = _timed(spmv2, solver.second_op, tmp, iters=iters)
    gram = jax.jit(lambda a, b: dense.gram_mod(f, a, b))
    t_gram, vtAv = _timed(gram, v, Av, iters=iters)
    semi = jax.jit(lambda u: semi_inverse_device(f, u))
    t_semi, (winv, d, npiv) = _timed(semi, vtAv, iters=iters)
    from block_lanczos_tpu.models.lanczos import orthogonalize_device
    orth = jax.jit(lambda v, Av, p, d, u, w: orthogonalize_device(
        f, v, Av, p, d, u, u, w))
    p_blk = jnp.zeros_like(v)
    t_orth, _ = _timed(orth, v, Av, p_blk, d, vtAv, winv, iters=iters)

    nnz = solver.sp.nnz if hasattr(solver, "sp") else None
    total = t_spmv1 + t_spmv2 + t_gram + t_semi + t_orth
    report = {
        "spmv_first_s": t_spmv1,
        "spmv_second_s": t_spmv2,
        "gram_s": t_gram,
        "semi_inverse_s": t_semi,
        "orthogonalize_s": t_orth,
        "total_s": total,
        "spmv_share": (t_spmv1 + t_spmv2) / total,
    }
    if nnz:
        report["spmv_nnz_per_s"] = 2 * nnz / (t_spmv1 + t_spmv2)
    return report
