"""Solver command-line interface.

Flag-compatible with the reference solver's getopt surface
(reference: sequential/lanczos_modp.c:124-194 and the MPI variant's
checkpoint flags, mpi/lanczos_modp.c:156-245):

    lanczos-modp --matrix M.mtx --prime 65537 --n 4 [--output-file K.mtx]
                 [--right | --left] [--stop-after N]
                 [--checkpoint [SECONDS]] [--load-checkpoint]
                 [--checkpoint-dir DIR]

Additions: --devices (mesh size; default all), --single (force the
single-device driver), --no-checks (disable per-iteration invariant
asserts — the reference's "disable in production").
"""

from __future__ import annotations

import argparse
import sys

from block_lanczos_tpu.ops.gfp import PRIME_CAP
from block_lanczos_tpu.utils import checkpoint as ckpt
from block_lanczos_tpu.utils import mmio
from block_lanczos_tpu.utils.verbosity import VerbosityEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lanczos-modp",
        description="block Lanczos kernel vectors of a sparse matrix mod p")
    ap.add_argument("--matrix", required=True,
                    help="MatrixMarket file containing the sparse matrix")
    ap.add_argument("--prime", required=True, type=int,
                    help="compute modulo P")
    ap.add_argument("--n", type=int, default=1,
                    help="blocking factor [default 1]")
    ap.add_argument("--output-file",
                    help="store the block of kernel vectors")
    ap.add_argument("--right", action="store_true",
                    help="compute right kernel vectors")
    ap.add_argument("--left", action="store_true",
                    help="compute left kernel vectors [default]")
    ap.add_argument("--stop-after", type=int, default=-1,
                    help="stop the algorithm after N iterations")
    ap.add_argument("--checkpoint", nargs="?", const=60.0, type=float,
                    default=None, metavar="SECONDS",
                    help="checkpoint every SECONDS seconds [default 60]")
    ap.add_argument("--load-checkpoint", action="store_true",
                    help="resume from the checkpoint directory")
    ap.add_argument("--checkpoint-dir", default="lanczos_checkpoint",
                    help="checkpoint directory [default lanczos_checkpoint]")
    ap.add_argument("--devices", type=int, default=None,
                    help="number of mesh devices [default: all]")
    ap.add_argument("--grid", type=int, nargs=2, metavar=("R", "C"),
                    default=None,
                    help="explicit 2D device grid (rows cols)")
    ap.add_argument("--single", action="store_true",
                    help="force the single-device driver")
    ap.add_argument("--no-checks", action="store_true",
                    help="disable per-iteration invariant checks")
    ap.add_argument("--overlap", action="store_true",
                    help="chunk each SpMV so exact reductions overlap local "
                         "compute (mesh solvers, all three fields)")
    ap.add_argument("--salvage", action="store_true",
                    help="on a failed final check, extract the verified "
                         "kernel combinations from the partial block "
                         "(the reference just reports KO)")
    ap.add_argument("--salvage-restarts", type=int, default=0, metavar="K",
                    help="with --salvage: if the salvaged yield is short of "
                         "n, re-solve up to K times with fresh random blocks "
                         "(the xoshiro stream continues) and combine the "
                         "exactly-independent verified vectors across runs")
    ap.add_argument("--no-dedup", action="store_true",
                    help="GF(2) only: keep duplicate/empty operator lines "
                         "verbatim like the reference (default: drop "
                         "duplicates to restore rank(A) on structured "
                         "instances; a no-op on duplicate-free matrices)")
    ap.add_argument("--sync-every", type=int, default=None, metavar="K",
                    help="iterations per host sync (device-side loop size); "
                         "default: adaptive doubling up to 1024. Use 1 for "
                         "exact per-iteration callbacks")
    # multi-host (multi-controller) execution — the mpiexec analogue: launch
    # one copy of this CLI per host with the same coordinator address
    # (reference: mpi/lanczos_modp.c:505-566, README.md:39-46)
    ap.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                    help="multi-host coordinator address; launch one process "
                         "per host with identical flags")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="total number of participating processes")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's rank in [0, num-processes)")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="force N virtual CPU devices in this process "
                         "(multi-host testing without accelerators)")
    return ap


def main(argv=None) -> int:
    import jax

    from block_lanczos_tpu.utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if args.coordinator is not None:
        from block_lanczos_tpu.parallel.multihost import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id,
                         local_device_count=args.local_devices)
    is_root = jax.process_index() == 0
    if args.output_file and args.stop_after > 0:
        print("--stop-after and --output-file are mutually exclusive",
              file=sys.stderr)
        return 1
    wide = args.prime > PRIME_CAP
    if wide and args.prime >= (1 << 62):
        # the reference stops at 2^30 - 35; we extend to 2^62
        print(f"p is capped at 2**62 - 1 (got {args.prime})", file=sys.stderr)
        return 1
    right = args.right and not args.left

    try:
        M = mmio.load_mtx(args.matrix, args.prime, verbose=is_root)
    except (OSError, ValueError) as e:
        print(f"cannot load matrix {args.matrix}: {e}", file=sys.stderr)
        return 1
    if is_root:
        print(f"  - {M.nrows} x {M.ncols} with {M.nnz} nz", file=sys.stderr)

    field = ("wide" if wide
             else "gf2" if args.prime == 2 and args.n % 32 == 0
             else "narrow")
    run_meta = {"matrix": args.matrix, "prime": args.prime, "n": args.n,
                "right": right, "field": field,
                "nrows": M.nrows, "ncols": M.ncols, "nnz": M.nnz}

    resume_state = None
    extra_time = 0.0
    if args.load_checkpoint:
        try:
            resume_state = ckpt.load_checkpoint(args.checkpoint_dir)
        except (OSError, ValueError) as e:
            # ValueError covers corrupt manifests (json.JSONDecodeError)
            # and torn sharded snapshots (_load_sharded)
            print(f"cannot load checkpoint from {args.checkpoint_dir}: {e}",
                  file=sys.stderr)
            return 1
        try:
            ckpt.validate_meta(resume_state, run_meta)
        except ckpt.CheckpointMismatch as e:
            print(e, file=sys.stderr)
            return 1
        if is_root and resume_state.get("matrix") not in (None, args.matrix):
            print(f"  - note: checkpoint was written for matrix path "
                  f"{resume_state['matrix']!r} (shape/nnz match; continuing)",
                  file=sys.stderr)
        extra_time = float(resume_state.get("elapsed", 0.0))
        if is_root:
            print(f"Resuming from iteration {resume_state['iteration']} "
                  f"({args.checkpoint_dir})")

    # A 1-device mesh is mathematically identical to the single-device
    # driver.  The CLI picks the single driver only for solves of >= 20k
    # iterations (a policy set before the H100 port, where the single
    # driver compiled far slower).  On an H100 80GB HBM3 at a 400 W power
    # limit, narrow n=4 on the 4.5M-nnz bench matrix: single 22.5 s
    # compile and 0.96 ms/iter, 1x1 mesh 23.6 s and 0.91 ms/iter (one
    # smoke run).  Whether to keep both drivers is ROADMAP C3.
    if (not args.single and not args.overlap and args.grid is None
            and args.num_processes == 1):
        import jax
        n_dev = args.devices if args.devices else len(jax.devices())
        if n_dev == 1 and (M.ncols if not right else M.nrows) // max(args.n, 1) >= 20_000:
            args.single = True

    if wide:
        if is_root:
            print("  - wide field (p > 2^30): two-limb arithmetic",
                  file=sys.stderr)
        if args.single:
            from block_lanczos_tpu.models.lanczos_wide import BlockLanczosWide
            solver = BlockLanczosWide(M, n=args.n, right=right,
                                      check_invariants=not args.no_checks,
                                      sync_every=args.sync_every)
        else:
            from block_lanczos_tpu.parallel import make_mesh
            from block_lanczos_tpu.parallel.distributed_wide import \
                ShardedBlockLanczosWide
            from block_lanczos_tpu.parallel.mesh import make_mesh_grid
            mesh = (make_mesh_grid(*args.grid) if args.grid
                    else make_mesh(args.devices))
            solver = ShardedBlockLanczosWide(
                M, n=args.n, right=right, mesh=mesh,
                check_invariants=not args.no_checks,
                sync_every=args.sync_every, overlap=args.overlap)
    elif args.prime == 2 and args.n % 32 == 0:
        # the factorization case: bitsliced GF(2), 32 elements per word
        if is_root:
            print("  - GF(2) bitsliced path (p = 2, n % 32 == 0)",
                  file=sys.stderr)
        if args.single:
            from block_lanczos_tpu.models.lanczos_gf2 import BlockLanczosGF2
            solver = BlockLanczosGF2(M, n=args.n, right=right,
                                     check_invariants=not args.no_checks,
                                     sync_every=args.sync_every,
                                     dedup=not args.no_dedup)
        else:
            from block_lanczos_tpu.parallel import make_mesh
            from block_lanczos_tpu.parallel.distributed_gf2 import \
                ShardedBlockLanczosGF2
            from block_lanczos_tpu.parallel.mesh import make_mesh_grid
            mesh = (make_mesh_grid(*args.grid) if args.grid
                    else make_mesh(args.devices))
            solver = ShardedBlockLanczosGF2(
                M, n=args.n, right=right, mesh=mesh,
                check_invariants=not args.no_checks,
                sync_every=args.sync_every, overlap=args.overlap,
                dedup=not args.no_dedup)
    elif args.single:
        from block_lanczos_tpu.models.lanczos import BlockLanczos
        solver = BlockLanczos(M, n=args.n, right=right,
                              check_invariants=not args.no_checks,
                              sync_every=args.sync_every)
    else:
        from block_lanczos_tpu.parallel import make_mesh
        from block_lanczos_tpu.parallel.distributed import ShardedBlockLanczos
        from block_lanczos_tpu.parallel.mesh import make_mesh_grid
        if args.grid:
            mesh = make_mesh_grid(*args.grid)
        else:
            mesh = make_mesh(args.devices)
        solver = ShardedBlockLanczos(M, n=args.n, right=right, mesh=mesh,
                                     check_invariants=not args.no_checks,
                                     sync_every=args.sync_every,
                                     overlap=args.overlap)

    # The operator dimension m_eff depends on the GF(2) dedup setting, so a
    # checkpoint written under a different --no-dedup choice would continue
    # the recurrence under a DIFFERENT operator — refuse early rather than
    # waste a chip run on vectors the final check will reject.
    run_meta["m_eff"] = int(solver.m_eff)
    if resume_state is not None:
        try:
            ckpt.validate_meta(resume_state, run_meta)
        except ckpt.CheckpointMismatch as e:
            print(e, file=sys.stderr)
            if field == "gf2":
                print("  (an m_eff mismatch at equal nrows/ncols/nnz means "
                      "the checkpoint was written under a different GF(2) "
                      "dedup setting; rerun with the matching --no-dedup "
                      "choice)", file=sys.stderr)
            return 1

    verb = VerbosityEngine(solver.expected_iterations, extra_time=extra_time)
    verb.n_iterations = resume_state["iteration"] if resume_state else 0
    manager = None
    if args.checkpoint is not None:
        row_map = getattr(solver, "row_map", None)
        manager = ckpt.CheckpointManager(
            args.checkpoint_dir, interval_s=args.checkpoint,
            meta=run_meta, verbose=True,
            rowmap=None if row_map is None else row_map.rowmap())

    # Preemption-safe exit: SIGTERM/SIGINT request a checkpoint; the next
    # callback persists {v, p, iteration} and the run exits 128+signum so a
    # rescheduled job resumes with --load-checkpoint.  A second signal
    # before the save lands falls back to the default (immediate) action.
    # The reference has no preemption story — its timer checkpoint loses up
    # to interval_s of work on kill (mpi/lanczos_modp.c:1781-1790).
    preempt = {"signum": None}
    if manager is not None:
        import signal

        def _on_signal(signum, frame):
            preempt["signum"] = signum
            manager.request_save()
            signal.signal(signum, signal.SIG_DFL)

        for _sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(_sig, _on_signal)

    class _PreemptionSaved(Exception):
        pass

    def on_iteration(slv, iteration, v, p_blk, start):
        # iteration == 0 happens when the very first probe converges (the
        # stopping iteration is uncounted): nothing to report, but the
        # checkpoint due-check below must still run (it is collective).
        verb.n_iterations = max(iteration - 1, 0)
        if is_root and iteration > 0:
            verb.tick(start)
        if manager is not None:  # collective in multi-process mode
            saved = manager.maybe_save(iteration, v, p_blk, start,
                                       extra_time=extra_time)
            if saved and preempt["signum"] is not None:
                raise _PreemptionSaved

    try:
        res = solver.solve(stop_after=args.stop_after, verbose=is_root,
                           on_iteration=on_iteration,
                           resume_state=resume_state)
    except _PreemptionSaved:
        if is_root:
            print(f"\nReceived signal {preempt['signum']}; state "
                  f"checkpointed to {args.checkpoint_dir} — resume with "
                  "--load-checkpoint", file=sys.stderr)
        return 128 + int(preempt["signum"])
    if is_root:
        print()
    kernel, n_cols = res.kernel, args.n
    if args.salvage and res.product_zero is False and res.vtM is not None:
        from block_lanczos_tpu.utils.salvage import (salvage_kernel,
                                                     salvage_with_restarts)
        if args.salvage_restarts > 0:
            # restart solves skip the checkpoint machinery: each is a
            # fresh independent block, not a resumable recurrence
            salvaged = salvage_with_restarts(
                lambda: solver.solve(stop_after=args.stop_after,
                                     verbose=is_root),
                res, args.prime, args.n, restarts=args.salvage_restarts,
                verbose=is_root)
        else:
            salvaged = salvage_kernel(res.kernel, res.vtM, args.prime)
            if is_root:
                print(f"Salvage: recovered {salvaged.shape[1]} / {args.n} "
                      "verified kernel vectors from the partially-converged "
                      "block")
        if salvaged.shape[1] == 0:
            print("Salvage found no kernel vectors", file=sys.stderr)
            return 1
        kernel, n_cols = salvaged, salvaged.shape[1]
    if args.output_file:
        if is_root:
            print(f"Saving result in {args.output_file}")
            mmio.write_kernel_mtx(args.output_file, kernel,
                                  solver.n_eff, n_cols)
    elif is_root:
        print("Not saving result (no --output given)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
