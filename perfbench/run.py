"""Run one cell of the port's benchmark once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  Prints the
card on standard error, each number that decides ``correct`` beside its
limit as the last lines there, and one JSON object as the last line of
standard output (see ``perfbench/harness.py``).  Exits 1 without a result
where there is no card.
"""

import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CUDA driver's kernel cache inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH",
                      os.path.join(ROOT, "build", "cuda_cache"))
# the checkout's root in place of this script's folder, whose module names
# (trace, program) would shadow others'
sys.path[0] = ROOT


def process_age() -> float:
    """Seconds since this process started (Linux), to add the
    interpreter's own start to the set-up."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    started = STARTED - process_age()
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], started))
