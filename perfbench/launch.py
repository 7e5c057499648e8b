"""The parent of a cell's data-parallel run (``chips`` > 1 in
``BENCHMARK.json``): it builds the program's kernel once, then starts one
rank a card (``perfbench/rank.py``) with the variables ``torchrun`` sets,
waits for them, and prints rank 0's result as its own.  A rank that fails,
or ranks that outlast the run's timeout, end the run: every rank is killed
and the parent exits non-zero with each rank's tail, so that a hung NCCL
never hangs the run.  A rank dies with its parent (``rank.py``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 320.0   # seconds the ranks of a run may take, besides:
TRACE_TIMEOUT = 60.0   # with --trace 1, and --seconds itself
TAIL = 2000            # characters of each rank's output shown on failure
RANK = [sys.executable, "-m", "perfbench.rank"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_timeout(seconds: float, trace: bool) -> float:
    """The seconds a run's ranks may take together."""
    return RANK_TIMEOUT + seconds + TRACE_TIMEOUT * trace


def run_ranks(ranks: int, args: list, timeout: float,
              command: list = RANK) -> tuple:
    """``command`` + ``args`` in ``ranks`` processes, rank ``r`` with
    ``torchrun``'s variables for rank ``r`` of ``ranks`` on this host.
    Waits until all have exited 0, one has failed, or ``timeout`` seconds
    have passed; kills what is left.  Returns (whether all exited 0, each
    rank's exit code (None: killed while running), standard output and
    standard error of each, what ended the wait)."""
    port = free_port()
    threads = os.environ.get("OMP_NUM_THREADS",
                             str(max((os.cpu_count() or 1) // ranks, 1)))
    procs, files = [], []
    for rank in range(ranks):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(ranks),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(ranks), OMP_NUM_THREADS=threads)
        out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        files.append((out, err))
        procs.append(subprocess.Popen(command + args, cwd=ROOT, env=env,
                                      stdout=out, stderr=err))
    deadline = time.monotonic() + timeout
    why = "every rank exited 0"
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                why = f"rank {failed[0]} exited {codes[failed[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                why = f"the ranks outlasted {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        codes = [p.poll() for p in procs]
        for p in procs:
            p.kill()
            p.wait()
    texts = []
    for out, err in files:
        pair = []
        for f in (out, err):
            f.seek(0)
            pair.append(f.read().decode(errors="replace"))
            f.close()
        texts.append(pair)
    ok = all(c == 0 for c in codes)
    return (ok, codes, [o for o, _ in texts], [e for _, e in texts], why)


def main(args, chips: int, started: float) -> int:
    """The run of ``args`` (``perfbench/run.py``'s) on ``chips`` ranks, one
    card each; ``started``: this process's start on
    ``time.perf_counter``'s clock, from which rank 0 counts the set-up."""
    from perfbench import harness, program

    _, _, cell, _ = harness.spec(args.workload)
    if program.ranks(cell["traffic"]) != chips:
        print(f"perfbench: {args.workload} asks for {chips} chips and "
              f"{program.ranks(cell['traffic'])} ranks", file=sys.stderr)
        return 1
    harness.load_kernel("cuda")   # built once, before any rank loads it
    launched = time.time() - (time.perf_counter() - started)
    ok, codes, outs, errs, why = run_ranks(chips, [
        "--workload", args.workload, "--seeds", str(args.seed),
        "--seconds", repr(args.seconds), "--trace", str(args.trace),
        "--launched-at", repr(launched)],
        run_timeout(args.seconds, bool(args.trace)))
    for rank in range(1, chips):
        tail = errs[rank][-TAIL:] if not ok else errs[rank]
        sys.stderr.write("".join(f"rank {rank}: {line}\n"
                                 for line in tail.splitlines()))
    lines = outs[0].splitlines()
    if not ok or not lines:
        sys.stderr.write(errs[0][-TAIL:] + outs[0][-TAIL:])
        print(f"perfbench: {why}; exit codes {codes}", file=sys.stderr)
        return 1
    sys.stderr.write(errs[0])
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: loaded in this process: {found}",
              file=sys.stderr)
        return 1
    print(lines[-1], flush=True)
    return 0
