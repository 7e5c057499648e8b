"""One rank of a cell's data-parallel run, started by
``perfbench/launch.py`` with the variables ``torchrun`` sets:

    python3 -m perfbench.rank --workload <cell> --seeds <n>[,<n>...] \
        --seconds <s> --trace <0|1> --launched-at <the parent's start>

from the root of a checkout.  The rank enters the program as a user's
data-parallel script does (``parallel/mesh.py``'s
``initialize_distributed`` and ``make_mesh``, then the harness builds the
trainer at the global arena count and calls ``shard_train_state``) and
runs ``harness.run`` once a seed; rank 0 prints each result as the last
line of its standard output.  ``--fault``, ``--control``, ``--shrink`` and
``--device cpu`` serve the readings and the tests (``--shrink``: a
function ``module:name`` that edits the configuration and the cell).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import json
import os
import signal
import sys
import time

PR_SET_PDEATHSIG = 1


def die_with_parent():
    """Have the kernel kill this rank when the process that started it
    ends, so that no rank outlives a killed run (Linux)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        return
    if os.getppid() == 1:   # the parent ended before the call
        os._exit(1)


def main(argv=None) -> int:
    die_with_parent()
    parser = argparse.ArgumentParser(prog="perfbench.rank")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--launched-at", type=float, required=True,
                        help="the parent's start (time.time()), from which "
                             "the set-up is counted")
    parser.add_argument("--fault", default="")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--shrink", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from perfbench import faults, harness
    from reinforcement_learning_torch.parallel import mesh as meshmod

    started = time.perf_counter() - (time.time() - args.launched_at)
    reached = {"rank's imports": time.perf_counter() - started}
    meshmod.initialize_distributed(device=args.device)
    mesh = meshmod.make_mesh()
    gloo = dist.new_group(backend="gloo")   # the captures, to rank 0
    reached["process groups"] = time.perf_counter() - started
    print("perfbench: rank reached (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in reached.items()), file=sys.stderr)
    shrink = None
    if args.shrink:
        module, name = args.shrink.split(":")
        shrink = getattr(importlib.import_module(module), name)
    planted = (faults.FAULTS[args.fault]() if args.fault
               else contextlib.nullcontext())
    seeds = [int(s) for s in args.seeds.split(",")]
    rc = 0
    with planted:
        for seed in seeds:
            t0 = time.perf_counter()
            result = harness.run(args.workload, seed, args.seconds,
                                 bool(args.trace), args.device, started,
                                 shrink, mesh=mesh, gloo=gloo,
                                 control=args.control)
            started = time.perf_counter()   # a later seed's own set-up
            if result is None:
                continue
            if len(seeds) > 1 or args.control or args.fault:
                result = dict(seed=seed, fault=args.fault or None,
                              seconds=time.perf_counter() - t0, **result)
            rc |= harness.report(result)
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
