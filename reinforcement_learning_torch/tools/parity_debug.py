"""Tick-by-tick divergence dump for one parity scenario (the twin of the
JAX package's ``tools/parity_debug.py``).

Usage: python -m reinforcement_learning_torch.tools.parity_debug
    <scenario> [T] [--car=N] [--fields=a,b] [--device=cpu] [--oracle=PATH]
Prints, per tick, ref vs torch values of selected fields and running
error, so the exact tick where a scenario diverges is visible.  The
portable engine (``parity.run_torch``), on the card unless
``--device=cpu``.
"""
import sys

import numpy as np

from reinforcement_learning_torch.tools import parity, parity_battery


def dump(ref, ours, T, fields, car=0):
    """Prints ``fields`` of the two traces, tick by tick."""
    gcf = parity.car_trace_field
    for t in range(T):
        parts = [f"t={t:4d}"]
        for f in fields:
            if f.startswith("ball_"):
                sl = {"ball_pos": slice(0, 3), "ball_vel": slice(3, 6),
                      "ball_ang": slice(6, 9)}[f]
                rv, ov = ref["ball"][t, sl], ours["ball"][t, sl]
            else:
                rv = np.atleast_1d(gcf(ref["cars"], f)[t, car])
                ov = np.atleast_1d(gcf(ours["cars"], f)[t, car])
            err = np.abs(rv - ov).max()
            parts.append(f"{f}: ref={np.round(rv, 3)} "
                         f"torch={np.round(ov, 3)} err={err:.3f}")
        print("  ".join(parts))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    name = args[0]
    T = int(args[1]) if len(args) > 1 else 120
    car = 0
    fields = ["pos", "vel", "ang_vel"]
    for a in sys.argv[1:]:
        if a.startswith("--car="):
            car = int(a.split("=")[1])
        if a.startswith("--fields="):
            fields = a.split("=")[1].split(",")

    sc = parity_battery.scenarios(T)[name]
    ref = parity.run_oracle([sc],
                            oracle_bin=parity_battery.option("oracle"))[0]
    ours = parity.run_torch([sc], device=parity_battery.option("device"))[0]
    dump(ref, ours, T, fields, car)


if __name__ == "__main__":
    main()
