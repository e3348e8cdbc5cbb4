#!/usr/bin/env python
"""Flat mesh vs multi-process (hybrid) mesh at equal device count.

The reference ships benchmarks/mpi_vs_hybrid.csv: the same solve run
MPI-pure (one rank per core) vs hybrid (MPI ranks x OpenMP threads),
measuring what the extra process boundary costs at equal parallelism.
The analogue here: the same ("rows","cols") device mesh driven by
ONE controller process vs SPLIT across jax.distributed controller
processes (multi-host SPMD, parallel/multihost.py) — same program, same
collectives, but cross-process coordination on the dispatch path.

Across hosts the split rides the network; on one CPU host it runs the
virtual CPU mesh, so the measured delta is the multi-controller dispatch
overhead (the machinery's cost floor), not network. Same honesty rules as
benchmarks/scaling.py.

Per-iteration time comes from the CLI's own "Terminated in Xs after N
iterations" line, differenced between a long and a short run so compile
and matrix build cancel.

Usage: python benchmarks/hybrid_compare.py [--devices 8] [--out CSV]
"""

import argparse
import csv
import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TERM_RE = re.compile(r"Terminated in ([0-9.]+)s after (\d+) iterations")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_config(mtx: str, prime: int, n: int, stop_after: int,
               num_processes: int, local_devices: int,
               timeout: float = 900.0) -> tuple[float, int]:
    """One solve; returns (solver wall seconds, iterations done)."""
    devices = num_processes * local_devices
    common = ["--matrix", mtx, "--prime", str(prime), "--n", str(n),
              "--devices", str(devices), "--stop-after", str(stop_after),
              "--no-checks"]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    if num_processes == 1:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            f" --xla_force_host_platform_device_count="
                            f"{local_devices}").strip()
        argv = [sys.executable, "-m", "block_lanczos_tpu.utils.cli"] + common
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    else:
        env.pop("XLA_FLAGS", None)   # --local-devices supplies the count
        port = _free_port()
        for pid in range(num_processes):
            argv = ([sys.executable, "-m", "block_lanczos_tpu.utils.cli",
                     "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", str(num_processes),
                     "--process-id", str(pid),
                     "--local-devices", str(local_devices)] + common)
            procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"rank failed rc={p.returncode}:\n{out}")
    m = TERM_RE.search(outs[0])   # rank 0 prints the verbosity line
    if not m:
        raise RuntimeError(f"no termination line in output:\n{outs[0]}")
    return float(m.group(1)), int(m.group(2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--nrows", type=int, default=120_000)
    ap.add_argument("--ncols", type=int, default=80_000)
    ap.add_argument("--density", type=int, default=12)
    ap.add_argument("--prime", type=int, default=65537)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--long", type=int, default=128)
    ap.add_argument("--short", type=int, default=16)
    ap.add_argument("--out", default="/tmp/blanczos_hybrid.csv")
    args = ap.parse_args()

    from block_lanczos_tpu.utils.gen import write_random_mtx
    mtx = (f"/tmp/blanczos_bench/hybrid_{args.nrows}x{args.ncols}"
           f"_d{args.density}.mtx")
    if not os.path.exists(mtx):
        os.makedirs(os.path.dirname(mtx), exist_ok=True)
        write_random_mtx(mtx, args.nrows, args.ncols, args.density, seed=42)

    # (label, processes, local devices) — equal total devices throughout.
    # Process split capped at 4: beyond that a single-core host measures
    # OS oversubscription, not the multi-controller dispatch cost.
    configs = [("flat", 1, args.devices)]
    np_split = 2
    while np_split <= min(args.devices, 4):
        configs.append((f"hybrid_{np_split}p", np_split,
                        args.devices // np_split))
        np_split *= 2
    rows = []
    for label, nproc, ldev in configs:
        t_long, k_long = run_config(mtx, args.prime, args.n, args.long,
                                    nproc, ldev)
        t_short, k_short = run_config(mtx, args.prime, args.n, args.short,
                                      nproc, ldev)
        per = (t_long - t_short) / max(k_long - k_short, 1)
        rows.append({"config": label, "processes": nproc,
                     "local_devices": ldev,
                     "s_per_iteration": round(per, 6)})
        print(f"{label:>10}: {per:.4f} s/iter "
              f"({nproc} proc x {ldev} dev)", flush=True)

    base = rows[0]["s_per_iteration"]
    for r in rows:
        r["overhead_vs_flat"] = round(r["s_per_iteration"] / base, 4)
    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
