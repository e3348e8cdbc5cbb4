#!/usr/bin/env python
"""Smoke run of the block Lanczos solver on an NVIDIA GPU.

Drives the main path through the user entry points (the CLI, called
in-process, and the library API) at real sizes and checks every result by
the repository's own means: the committed C-reference golden kernels,
the independent checker (utils/checker.py) and exact host references.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards: the mesh paths only

Output: the card's name and power limit, one line per phase (pass/fail,
compile seconds, steady s/iter, peak device bytes), then one JSON line
{"ok": true, "device": {...}}.  The timings are smoke timings from one
run, not benchmark results.  Exits nonzero, without the JSON line, when
JAX finds no GPU or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from block_lanczos_tpu.models.lanczos import BlockLanczos
from block_lanczos_tpu.models.lanczos_gf2 import BlockLanczosGF2
from block_lanczos_tpu.models.lanczos_wide import BlockLanczosWide
from block_lanczos_tpu.ops import dense
from block_lanczos_tpu.ops.gfp import GFp
from block_lanczos_tpu.parallel.distributed import ShardedBlockLanczos
from block_lanczos_tpu.parallel.distributed_gf2 import (
    ShardedBlockLanczosGF2, partition_matrix_gf2)
from block_lanczos_tpu.parallel.distributed_wide import ShardedBlockLanczosWide
from block_lanczos_tpu.parallel.mesh import make_mesh, make_mesh_grid
from block_lanczos_tpu.utils import checker, cli, mmio
from block_lanczos_tpu.utils.compile_cache import enable_compile_cache
from block_lanczos_tpu.utils.gen import random_coo, write_random_mtx
from block_lanczos_tpu.utils.profiling import (compile_loop, loop_s_per_iter,
                                               solver_loop)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

P_NARROW = 1073741789
P_WIDE = (1 << 61) - 1
# the bench matrix: 300k x 200k, 15 nnz/row, 4.5M nnz, seed 42
BENCH = dict(nrows=300_000, ncols=200_000, row_density=15, seed=42)
# a tenth of each bench dimension: a wide solve at the bench shape takes
# ~50k iterations, so the complete wide solve (and the four-card CLI
# solves) run here and the bench shape runs with stop_after
TENTH = dict(nrows=30_000, ncols=20_000, row_density=15, seed=42)
# small enough that an iteration costs next to nothing on the card
SMALL = dict(nrows=3_000, ncols=2_000, row_density=15, seed=42)
# the largest GF(2) size the repository supports: 3M x 2M, 17/row, 51M nnz
GF2_51M = dict(nrows=3_000_000, ncols=2_000_000, row_density=17, seed=42)

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class PhaseFailed(Exception):
    pass


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_kw):
        if event in _COMPILE_EVENTS:
            self.total += duration


def peak_bytes():
    """Peak device bytes in use so far in this process (None on CPU): JAX
    cannot reset the peak, so a phase's figure includes every earlier
    phase's."""
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def write_matrix(spec, path):
    write_random_mtx(path, **spec)
    return path


def run_cli(argv, log_path):
    """cli.main in-process; returns (rc, iterations, solve seconds).

    The CLI's own output goes to `log_path`; its "Terminated in" line gives
    the iteration count and the solve's wall time (compile included)."""
    out = io.StringIO()
    with open(log_path, "a") as log, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(log):
        rc = cli.main(argv)
    text = out.getvalue()
    with open(log_path, "a") as log:
        log.write(text)
    m = re.search(r"Terminated in ([0-9.]+)s after (\d+) iterations", text)
    if m is None:
        return rc, None, None
    return rc, int(m.group(2)), float(m.group(1))


def timed_solve(solver, warm: int, iters: int):
    """(result, steady s/iter): a warm solve compiles, a second one times."""
    solver.solve(stop_after=warm)
    t0 = time.perf_counter()
    res = solver.solve(stop_after=iters)
    return res, (time.perf_counter() - t0) / max(res.iterations, 1)


def np_gram_mod(p, V, W):
    """Exact V^T W mod p on the host: 15-bit limbs, float64 products.

    Every limb product is < 2^30 and every column sum < N * 2^30 < 2^53
    for N < 2^23 rows, so the float64 matrix products are exact."""
    assert V.shape[0] < (1 << 23)
    Vh, Vl = (V >> 15).astype(np.float64), (V & 0x7FFF).astype(np.float64)
    Wh, Wl = (W >> 15).astype(np.float64), (W & 0x7FFF).astype(np.float64)
    def mm(a, b):
        return (a.T @ b).astype(np.uint64) % np.uint64(p)
    hh, hl, lh, ll = mm(Vh, Wh), mm(Vh, Wl), mm(Vl, Wh), mm(Vl, Wl)
    s15 = np.uint64((1 << 15) % p)
    s30 = np.uint64((1 << 30) % p)
    out = (hh * s30 % np.uint64(p) + (hl + lh) % np.uint64(p) * s15
           + ll) % np.uint64(p)
    return out.astype(np.uint32)


# ---------------------------------------------------------------------------
# phases: each returns a dict of figures to print, or raises PhaseFailed
# ---------------------------------------------------------------------------

def phase_golden(name, prime, n, right, work):
    """One committed golden config through the CLI, byte for byte."""
    out = os.path.join(work, f"{name}.kernel.mtx")
    argv = ["--matrix", os.path.join(GOLDEN, f"{name}.mtx"),
            "--prime", str(prime), "--n", str(n), "--output-file", out]
    if right:
        argv.append("--right")
    rc, iters, solve_s = run_cli(argv, os.path.join(work, "cli.log"))
    if rc != 0:
        raise PhaseFailed(f"cli rc={rc}")
    with open(out, "rb") as a, \
            open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as b:
        if a.read() != b.read():
            raise PhaseFailed("kernel differs from the C reference golden")
    return {"iterations": iters, "solve_s": solve_s,
            "check": "byte-identical with C reference"}


def phase_cli_solve(mtx, prime, n, work, tag, extra=()):
    """A complete CLI solve, its output verified by the checker."""
    out = os.path.join(work, f"{tag}.kernel.mtx")
    rc, iters, solve_s = run_cli(
        ["--matrix", mtx, "--prime", str(prime), "--n", str(n),
         "--output-file", out, *extra], os.path.join(work, "cli.log"))
    if rc != 0:
        raise PhaseFailed(f"cli rc={rc}")
    t0 = time.perf_counter()
    try:
        checker.check_kernel_file(mtx, out, prime)
    except checker.CheckFailure as e:
        raise PhaseFailed(f"checker: {e}") from e
    return {"iterations": iters, "solve_s": solve_s, "check": "checker OK",
            "checker_s": round(time.perf_counter() - t0, 3), "output": out}


def phase_cli_stop_after(mtx, prime, n, iters, work):
    """A bounded CLI run (invariant checks on) of a solve too long for the
    smoke budget; the device asserts the Lanczos invariants every step."""
    rc, done, solve_s = run_cli(
        ["--matrix", mtx, "--prime", str(prime), "--n", str(n),
         "--stop-after", str(iters)], os.path.join(work, "cli.log"))
    if rc != 0 or done != iters:
        raise PhaseFailed(f"cli rc={rc}, iterations {done} != {iters}")
    return {"iterations": done, "solve_s": solve_s,
            "check": "per-iteration invariants held"}


def phase_gram(n, nrows, seed=0):
    """XLA's dense.gram_mod at the solver's [v|Av]^T Av shape, timed, and
    compared with the exact host product."""
    f = GFp.make(P_NARROW)
    rng = np.random.default_rng(seed)
    V = rng.integers(0, P_NARROW, (nrows, 2 * n), dtype=np.uint32)
    W = rng.integers(0, P_NARROW, (nrows, n), dtype=np.uint32)
    Vd, Wd = jnp.asarray(V), jnp.asarray(W)
    gram = jax.jit(lambda a, b: dense.gram_mod(f, a, b))
    got = np.asarray(jax.block_until_ready(gram(Vd, Wd)))
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        out = gram(Vd, Wd)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    if not np.array_equal(got, np_gram_mod(P_NARROW, V, W)):
        raise PhaseFailed("gram_mod differs from the exact host product")
    return {"shape": f"({nrows},{2 * n})x({nrows},{n})",
            "smoke_s_per_call": dt, "check": "exact host product"}


def phase_single_vs_mesh(M, n, iters, clock):
    """BlockLanczos and the 1x1 ShardedBlockLanczos: compile seconds and
    s/iter of each (the CLI's choice between them), bit-exact iterates."""
    out, kernels = {}, []
    for tag, make in (("single", lambda: BlockLanczos(
                          M, n=n, check_invariants=False)),
                      ("mesh1x1", lambda: ShardedBlockLanczos(
                          M, n=n, mesh=make_mesh(1), check_invariants=False))):
        solver = make()
        c0 = clock.total
        res, s_iter = timed_solve(solver, 2, iters)
        out[f"{tag}_compile_s"] = round(clock.total - c0, 3)
        out[f"{tag}_smoke_s_per_iter"] = s_iter
        kernels.append(np.asarray(res.kernel))
    if not np.array_equal(*kernels):
        raise PhaseFailed("single and 1x1-mesh iterates differ")
    out["check"] = f"bit-exact after {iters} iterations"
    return out


def phase_iteration_floor(spec, iters=400):
    """The per-iteration floor at a tiny size: narrow n=4 on a matrix too
    small for its SpMVs and Gram products to cost much (the 1x1 mesh, as
    the CLI picks for it), so every kernel launch of one iteration and
    the while_loop's own trip are most of what is timed."""
    solver = ShardedBlockLanczos(random_coo(**spec, prime=P_NARROW), n=4,
                                 mesh=make_mesh(1), check_invariants=False)
    s_iter, done = loop_s_per_iter(*solver_loop(solver), iters, warmup=1)
    if done != iters:
        raise PhaseFailed(f"{done} iterations in the dispatch, not {iters}")
    return {"smoke_s_per_iter": s_iter, "iters": iters}


def phase_gf2_at_scale(spec, blockings, iters, loop_iters=16):
    """51M-nnz GF(2) through the library API with what the CLI picks at
    this size (the 1x1 mesh; < 20k iterations): set-up costs, compile,
    memory, a few iterations with the device-side invariant checks.  Run
    first in its process, so that each blocking's process peak is its own
    or the smaller blocking's before it."""
    t0 = time.perf_counter()
    M = random_coo(**spec, prime=2)
    gen_s = time.perf_counter() - t0
    mesh = make_mesh(1)
    t0 = time.perf_counter()
    ops = partition_matrix_gf2(M, False, mesh)
    leaves = jax.tree_util.tree_leaves((ops.first.leaves(),
                                        ops.second.leaves()))
    jax.block_until_ready(leaves)
    build_put_s = time.perf_counter() - t0
    # host-to-device transfer: the same operator bytes put again
    host = [np.asarray(x) for x in leaves]
    t0 = time.perf_counter()
    jax.block_until_ready([jax.device_put(h, x.sharding)
                           for h, x in zip(host, leaves)])
    put_s = time.perf_counter() - t0
    out = {"nnz": M.nnz, "gen_s": round(gen_s, 3),
           "host_build_s": round(build_put_s - put_s, 3),
           "h2d_s": round(put_s, 3),
           "operator_bytes": int(sum(h.nbytes for h in host))}
    del host
    for n in blockings:
        solver = ShardedBlockLanczosGF2(M, n=n, mesh=mesh, ops=ops)
        program, secs = compile_loop(solver)
        out[f"n{n}_compile_s"] = round(secs, 3)
        mem = program.memory_analysis()
        if mem is not None:
            out[f"n{n}_memory_analysis"] = {
                k: int(getattr(mem, k)) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes")
                if hasattr(mem, k)}
        res = solver.solve(stop_after=iters)
        if res.iterations != iters or not res.kernel.any():
            raise PhaseFailed(f"n={n}: {res.iterations} iterations, "
                              f"expected {iters} with a nonzero block")
        out[f"n{n}_smoke_s_per_iter"] = loop_s_per_iter(
            *solver_loop(solver), loop_iters, warmup=1)[0]
        out[f"n{n}_process_peak_bytes"] = peak_bytes()
        del solver, program
    out["check"] = "device invariants held, block nonzero"
    return out


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

MESH_SOLVERS = {"narrow": (BlockLanczos, ShardedBlockLanczos),
                "wide": (BlockLanczosWide, ShardedBlockLanczosWide),
                "gf2": (BlockLanczosGF2, ShardedBlockLanczosGF2)}


def field_of(prime):
    return ("gf2" if prime == 2 else
            "wide" if prime > 0x3FFFFFDD else "narrow")


def mesh_layouts(M, n, grids):
    """{layout: constructor} of the field's mesh solver on every layout in
    grids x {plain, --overlap}."""
    sharded = MESH_SOLVERS[field_of(M.prime)][1]
    return {f"{g[0]}x{g[1]}{'+overlap' if ov else ''}":
            partial(sharded, M, n=n, mesh=make_mesh_grid(*g), overlap=ov)
            for g in grids for ov in (False, True)}


def one_card_reference(M, n, iters):
    """The field's single-device solver's block after `iters` iterations,
    from its second v0 draw: compile_loop takes the first from each mesh
    solver, so every solve compared here starts from the same v0."""
    ref = MESH_SOLVERS[field_of(M.prime)][0](M, n=n)
    ref.initial_block()
    return np.asarray(ref.solve(stop_after=iters).kernel)


def built_and_compiled(make):
    """(solver, compile seconds): the solver `make()` builds, its device
    loop compiled ahead of time and not run (compile_loop)."""
    solver = make()
    return solver, compile_loop(solver)[1]


def in_threads(jobs):
    """{key: job()}, each job in a thread of its own.  XLA compiles and
    NumPy builds outside the GIL, so building and compiling every solver
    costs about the longest job, not the sum.  No job may execute a mesh
    program: those share the cards' NCCL communicators and run later
    from the main thread, one at a time (mesh solves run from several
    threads at once ended in CUDA_ERROR_ILLEGAL_ADDRESS)."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def phase_mesh_parity(ref_kernel, solvers, iters, loop_iters=20):
    """Every mesh solver in `solvers` ({layout: solver}, compiled and not
    yet run) bit-exact with the one-card block `ref_kernel`
    after `iters` iterations, run and dropped one at a time; also the
    steady s/iter of each layout's device loop (smoke timings)."""
    out = {}
    for tag in list(solvers):
        solver = solvers.pop(tag)
        # names the layout on stderr before a crash that ends the process
        print(f"running {type(solver).__name__} {tag}", file=sys.stderr,
              flush=True)
        res = solver.solve(stop_after=iters)
        if not np.array_equal(np.asarray(res.kernel), ref_kernel):
            raise PhaseFailed(f"{type(solver).__name__} {tag} differs")
        out[f"{tag}_smoke_s_per_iter"] = loop_s_per_iter(
            *solver_loop(solver), loop_iters, warmup=1)[0]
        del solver, res
    out["check"] = f"bit-exact with one card after {iters} iterations"
    return out


def phase_gf2_mesh_scale(solvers, iters):
    """The same GF(2) solve on each count of cards, same iterates;
    `solvers` maps a card count to its solver, compiled and not yet run."""
    kernels, out = [], {}
    for k in list(solvers):
        solver = solvers.pop(k)
        kernels.append(np.asarray(solver.solve(stop_after=iters).kernel))
        out[f"{k}card_smoke_s_per_iter"] = loop_s_per_iter(
            *solver_loop(solver), iters, warmup=1)[0]
        del solver
    if not all(np.array_equal(kernels[0], k) for k in kernels[1:]):
        raise PhaseFailed("iterates differ between card counts")
    out["check"] = f"bit-exact after {iters} iterations"
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_two_process(mtx, prime, n, work, child_env, extra=()):
    """One solve as 2 processes through --coordinator; returns the output
    path.  child_env(i) gives process i its devices."""
    out = os.path.join(work, "two_process.kernel.mtx")
    port = free_port()
    procs = []
    for pid in (0, 1):
        argv = [sys.executable, "-m", "block_lanczos_tpu.utils.cli",
                "--matrix", mtx, "--prime", str(prime), "--n", str(n),
                "--coordinator", f"localhost:{port}", "--num-processes", "2",
                "--process-id", str(pid), "--devices", "4",
                "--output-file", out, *extra]
        log = open(os.path.join(work, f"two_process_{pid}.log"), "w")
        procs.append((subprocess.Popen(argv, cwd=ROOT, env=child_env(pid),
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    rcs = []
    try:
        for proc, _log in procs:
            rcs.append(proc.wait(timeout=300))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if rcs != [0, 0]:
        raise PhaseFailed(f"two-process rcs={rcs}")
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def gpu_identity():
    """`nvidia-smi --query-gpu=name,power.limit` lines, or a reason."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


class Runner:
    """Runs phases, prints one line each, remembers failures."""

    def __init__(self):
        self.clock = CompileClock()
        self.failed = []

    def run(self, name, fn, *args, **kw):
        c0, t0 = self.clock.total, time.perf_counter()
        try:
            figures = fn(*args, **kw)
            status = "PASS"
        except Exception as e:  # report every phase, fail the run at the end
            figures = {"error": f"{type(e).__name__}: {e}"}
            status = "FAIL"
            self.failed.append(name)
            traceback.print_exc(file=sys.stderr)
        figures = dict(figures or {})
        out = figures.pop("output", None)
        line = {"phase": name, "status": status,
                "compile_s": round(self.clock.total - c0, 3),
                "wall_s": round(time.perf_counter() - t0, 3),
                "process_peak_bytes": peak_bytes(), **figures}
        if line.get("iterations") and line.get("solve_s") is not None:
            line["smoke_s_per_iter"] = max(
                line["solve_s"] - line["compile_s"], 0.0) / line["iterations"]
        print("smoke " + json.dumps(line, default=str), flush=True)
        return out


def golden_configs():
    with open(os.path.join(GOLDEN, "MANIFEST.txt")) as fh:
        for row in fh:
            name, prime, n, right = row.split()
            yield name, int(prime), int(n), right == "True"


def run_one_card(r: Runner, work):
    r.run("gf2_51M_api", phase_gf2_at_scale, GF2_51M, (128, 256), 4)
    for name, prime, n, right in golden_configs():
        r.run(f"golden/{name}", phase_golden, name, prime, n, right, work)
    r.run("iteration_floor_narrow_n4", phase_iteration_floor, SMALL)
    mtx = os.path.join(work, "bench_300000x200000_d15_s42.mtx")
    r.run("write_bench_matrix", lambda: {"path": write_matrix(BENCH, mtx)})
    r.run("narrow_n32_4.5M_cli", phase_cli_solve, mtx, P_NARROW, 32, work,
          "narrow_n32")
    r.run("gf2_n128_4.5M_cli", phase_cli_solve, mtx, 2, 128, work, "gf2_n128")
    wide_mtx = write_matrix(TENTH, os.path.join(work, "wide_30k.mtx"))
    r.run("wide_n4_30k_cli", phase_cli_solve, wide_mtx, P_WIDE, 4, work,
          "wide_n4")
    r.run("wide_n4_4.5M_cli_stop_after", phase_cli_stop_after, mtx, P_WIDE,
          4, 200, work)
    for n in (4, 32):
        r.run(f"gram_xla_n{n}", phase_gram, n, BENCH["nrows"])
    M = mmio.load_mtx(mtx, P_NARROW)
    r.run("single_vs_mesh1x1_n4", phase_single_vs_mesh, M, 4, 200, r.clock)
    del M


FOUR_CARD_FIELDS = ((P_NARROW, 4), (P_WIDE, 4), (2, 128))


def run_four_cards(r: Runner, work, mtx, two_proc_out, spec=BENCH,
                   scale_spec=GF2_51M, iters=3, devices=4):
    """The multi-card phases: mesh parity per field at the bench size, a
    checked --devices 4 CLI solve of `mtx` compared with the two-process
    output of the same solve, and the 51M-nnz GF(2) matrix on 4 cards vs
    1.  The GF(2) mesh phases come last: on four H100s they have ended
    the process with CUDA_ERROR_ILLEGAL_ADDRESS (PERF.md, Findings)."""
    grids = ((devices, 1), (2, devices // 2))
    mats = {field_of(p): (random_coo(**spec, prime=p), n)
            for p, n in FOUR_CARD_FIELDS}
    M51 = random_coo(**scale_spec, prime=2)
    jobs = {(field, tag): partial(built_and_compiled, make)
            for field, (M, n) in mats.items()
            for tag, make in mesh_layouts(M, n, grids).items()}
    jobs.update({("gf2_51M", k): partial(built_and_compiled, partial(
        ShardedBlockLanczosGF2, M51, n=128, mesh=make_mesh(k)))
        for k in (1, devices)})
    # the one-card references: single-device programs, no collectives
    jobs.update({("ref", field): partial(one_card_reference, M, n, iters)
                 for field, (M, n) in mats.items()})
    built = {}

    def build():
        built.update(in_threads(jobs))
        secs = [v[1] for k, v in built.items() if k[0] != "ref"]
        return {"programs": len(jobs), "longest_compile_s": round(max(secs), 3)}
    r.run("build_and_compile_in_threads", build)

    def of(group):
        return {k[1]: built.pop(k)[0] for k in list(built) if k[0] == group}

    def parity(field):
        r.run(f"mesh_parity_{field}_n{mats[field][1]}",
              lambda: phase_mesh_parity(built[("ref", field)], of(field),
                                        iters))
    parity("narrow")
    parity("wide")
    one = r.run(f"narrow_n32_cli_devices{devices}", phase_cli_solve, mtx,
                P_NARROW, 32, work, "devices4",
                extra=("--devices", str(devices), "--no-checks"))

    def compare():
        if one is None or two_proc_out is None:
            raise PhaseFailed("a run it compares failed")
        with open(one, "rb") as a, open(two_proc_out, "rb") as b:
            if a.read() != b.read():
                raise PhaseFailed("2-process output differs from 1 process")
        return {"check": "byte-identical with the one-process output"}
    r.run("two_process_vs_one_process", compare)
    parity("gf2")
    r.run(f"gf2_51M_{devices}card_vs_1card",
          lambda: phase_gf2_mesh_scale(of("gf2_51M"), iters))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)
    print(gpu_identity(), flush=True)
    enable_compile_cache()
    r = Runner()
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as work:
        two_proc_out = None
        if args.four:
            if not shutil.which("nvidia-smi"):
                print("--four needs GPUs; nvidia-smi not found",
                      file=sys.stderr)
                return 1
            # the two child processes take two cards each, so they run
            # before this process reserves the cards' memory
            mtx = write_matrix(TENTH, os.path.join(work, "m30k.mtx"))
            env = dict(os.environ)
            two_proc_out = r.run(
                "two_process_2x2cards", lambda: {"output": phase_two_process(
                    mtx, P_NARROW, 32, work,
                    lambda i: {**env, "CUDA_VISIBLE_DEVICES":
                               "0,1" if i == 0 else "2,3"},
                    extra=("--no-checks",))})
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
            return 1
        if args.four:
            if len(jax.devices()) < 4:
                print(f"--four needs 4 GPUs, found {len(jax.devices())}",
                      file=sys.stderr)
                return 1
            run_four_cards(r, work, mtx, two_proc_out)
        else:
            run_one_card(r, work)
        if r.failed:
            print(f"failed phases: {r.failed}", file=sys.stderr)
            log = os.path.join(work, "cli.log")
            if os.path.exists(log):
                with open(log) as fh:
                    sys.stderr.write(fh.read()[-8000:])
            return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
