"""The readings that the limits of ``correct`` are set from, in one
process on the card:

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--faults half_batch,physics_altered --fault-seeds 1,2,3] \
        [--window <seconds>]

For each seed, a run's captures against the reference (the lower
readings) and the control (the reference in the next precision below the
configuration's in the program's place; the upper readings): the set-up's
iterations, a window of one iteration (ending in the cell's full skill
match where it plays them) and the iteration after it; for each fault of
``perfbench/faults.py`` and each of its seeds, the same with the fault
planted.  Nothing is timed.  One JSON line per
reading on standard output.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(workload: str, seed: int, device: str, fault=None,
            control: bool = False, shrink=None, seconds: float = 0.0) -> dict:
    """One set-up of ``workload``, a window of one iteration (or of whole
    iterations for ``seconds``, the policy trained further), and its
    numbers (and the control's)."""
    import contextlib

    import torch

    from perfbench import faults, harness, program
    from perfbench.reference import check

    _, _, cell, config = harness.spec(workload)
    if shrink is not None:
        shrink(config, cell)
    planted = (faults.FAULTS[fault]() if fault
               else contextlib.nullcontext())
    size = program.match_size(config, cell["traffic"])
    t0 = time.perf_counter()
    with planted:
        trainer = program.build(config, cell["traffic"], seed, device)
        probe = program.Probe(trainer, spans=False)
        weights = harness.make_weights(config, seed, device)
        state, cap = harness.setup(trainer, probe, weights, device)
        if size is not None:
            # the window's skill match, in its first iteration
            tracker = trainer.skill_tracker
            tracker.iterations_since_ran = tracker.config.update_interval - 1
        harness.arm_match(probe, seed, size)
        win = harness.window(trainer, probe, state, 1, seconds, device)
        _, post = harness.after_window(trainer, probe, win.pop("state"),
                                       seed, device)
        matches = list(probe.matches)
        probe.remove()
    del trainer, probe, state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed, "fault": fault,
           "setup_s": time.perf_counter() - t0,
           "iterations": win["iterations"],
           "numbers": check.numbers(config, weights, cap, post, matches,
                                    size, int(size is not None), device)}
    if control:
        out["control"] = check.control_numbers(config, weights, cap, post,
                                               matches, device)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/readings.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--window", type=float, default=0.0,
                        help="seconds of training before the iteration "
                             "after the window (default: one iteration)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 1

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    for seed in ints(args.seeds):
        print(json.dumps(reading(args.workload, seed, "cuda", control=True,
                                 seconds=args.window)), flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in ints(args.fault_seeds):
            print(json.dumps(reading(args.workload, seed, "cuda", fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUDA_CACHE_PATH",
                          os.path.join(ROOT, "build", "cuda_cache"))
    sys.path[0] = ROOT   # in place of this folder (see run.py)
    sys.exit(main())
