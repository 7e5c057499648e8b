"""Teacher-forced single-tick parity (the twin of the JAX package's
``tools/parity_teacher.py``): at every tick t the port's engine is reset
to the ORACLE's state at t-1, steps once, and is compared with the oracle
at t.  This separates per-tick mechanism error from chaotic amplification
of earlier micro-differences -- a scenario whose freerun diverges but
whose teacher-forced ticks all match has correct physics and merely
amplifies float noise (reference: two builds of the reference itself
diverge the same way).

Usage: python -m reinforcement_learning_torch.tools.parity_teacher
    <scenario> [T] [--from=t0] [--to=t1] [--ctick] [--device=cpu]
    [--oracle=PATH]

The default backend is the portable engine's ``arena_tick`` (the JAX
tool's ``xla``); ``--ctick`` steps the kernel route at ``tick_skip=1``:
``ops/arena_step.py`` ``arena_step``, which on the card launches the
kernel and on the CPU runs its plain version, ``ops/ctick.py`` ``step``
on the component layout of ``ops/pack.py``.  On the card unless
``--device=cpu``.
"""
import dataclasses
import sys

import numpy as np

from reinforcement_learning_torch.tools import parity, parity_battery


def run(name: str, T: int = 240, t0: int = 1, t1: int = None,
        quiet: bool = False, backend: str = "xla", device=None,
        oracle_bin=None):
    import torch

    from reinforcement_learning_torch.device import resolve_device
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.physics import step as stepmod

    dev = resolve_device(device)
    sc = parity_battery.scenarios(T)[name]
    ref = parity.run_oracle([sc], oracle_bin=oracle_bin)[0]
    gcf = parity.car_trace_field

    params = stepmod.ArenaParams(num_cars=sc.n_cars, use_mesh=True,
                                 dynamic_wheel_rays=(backend == "ctick"))
    phys0 = stepmod.make_physics_state(params, batch=(1,), device=dev)
    teams = tuple(c.team for c in sc.cars)
    ridx = torch.zeros((1, sc.n_cars), dtype=torch.int32, device=dev)

    if backend == "ctick":
        # the kernel route's single tick -- isolates the KERNEL's per-tick
        # mechanism error from chaotic amplification
        def tick(phys, controls):
            return A.arena_step(phys, controls, ridx, params, teams,
                                tick_skip=1, action_delay=0)
    else:
        def tick(phys, controls):
            cars = dataclasses.replace(phys.arena.cars, controls=controls)
            phys = dataclasses.replace(phys, arena=dataclasses.replace(
                phys.arena, cars=cars))
            return stepmod.arena_tick(phys, teams, ridx, params)

    def f(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)[None]

    def b(v):
        return torch.as_tensor(np.asarray(v) > 0.5, device=dev)[None]

    def load_state(t, carry=None):
        """PhysicsState (one arena) from the oracle trace at tick t
        (post-tick t).

        ``carry``: previous teacher-tick output PhysicsState -- its
        NON-observable internal state (wheel drive values, boost timers,
        flip torque, auto-flip state, world-contact latch) is kept, so
        only the oracle-observable fields are forced.  Without it those
        fields reset cold every tick.
        """
        cars_ref = ref["cars"]
        rot = np.stack([np.stack([gcf(cars_ref, "fwd")[t, c],
                                  gcf(cars_ref, "right")[t, c],
                                  gcf(cars_ref, "up")[t, c]], axis=-1)
                        for c in range(sc.n_cars)])
        base = carry if carry is not None else phys0
        cars = dataclasses.replace(
            base.arena.cars,
            pos=f(gcf(cars_ref, "pos")[t]),
            rot=f(rot),
            vel=f(gcf(cars_ref, "vel")[t]),
            ang_vel=f(gcf(cars_ref, "ang_vel")[t]),
            boost=f(gcf(cars_ref, "boost")[t]),
            is_on_ground=b(gcf(cars_ref, "is_on_ground")[t]),
            has_jumped=b(gcf(cars_ref, "has_jumped")[t]),
            has_double_jumped=b(gcf(cars_ref, "has_double_jumped")[t]),
            has_flipped=b(gcf(cars_ref, "has_flipped")[t]),
            jump_time=f(gcf(cars_ref, "jump_time")[t]),
            flip_time=f(gcf(cars_ref, "flip_time")[t]),
            is_jumping=b(gcf(cars_ref, "is_jumping")[t]),
            is_flipping=b(gcf(cars_ref, "is_flipping")[t]),
            air_time_since_jump=f(gcf(cars_ref, "air_time_since_jump")[t]),
            handbrake_val=f(gcf(cars_ref, "handbrake_val")[t]),
            last_controls=f(sc.controls[t]),
        )
        ball = dataclasses.replace(base.arena.ball,
                                   pos=f(ref["ball"][t, :3]),
                                   vel=f(ref["ball"][t, 3:6]),
                                   ang_vel=f(ref["ball"][t, 6:9]))
        return dataclasses.replace(base, arena=dataclasses.replace(
            base.arena, cars=cars, ball=ball))

    t1 = t1 if t1 is not None else T
    worst = {"ball_pos": 0.0, "ball_vel": 0.0, "car_pos": 0.0,
             "car_vel": 0.0, "car_ang": 0.0}
    worst_t = dict.fromkeys(worst, -1)
    carry = None
    for t in range(max(t0, 1), min(t1, T)):
        phys = load_state(t - 1, carry)
        out = tick(phys, f(sc.controls[t]))
        carry = out
        ball_row, car_rows = (r[0].cpu().numpy()
                              for r in parity._trace_rows(out.arena))
        errs = {
            "ball_pos": np.abs(ball_row[:3] - ref["ball"][t, :3]).max(),
            "ball_vel": np.abs(ball_row[3:6] - ref["ball"][t, 3:6]).max(),
            "car_pos": np.abs(gcf(car_rows, "pos")
                              - gcf(ref["cars"], "pos")[t]).max(),
            "car_vel": np.abs(gcf(car_rows, "vel")
                              - gcf(ref["cars"], "vel")[t]).max(),
            "car_ang": np.abs(gcf(car_rows, "ang_vel")
                              - gcf(ref["cars"], "ang_vel")[t]).max(),
        }
        for k, v in errs.items():
            if v > worst[k]:
                worst[k], worst_t[k] = float(v), t
        if not quiet and (errs["ball_vel"] > 0.4 or errs["car_vel"] > 0.4):
            print(f"t={t:4d} " + " ".join(f"{k}={v:8.3f}"
                                          for k, v in errs.items()))
    print(f"TEACHER {name}: worst single-tick errors over "
          f"[{max(t0,1)},{min(t1,T)}):")
    for k in worst:
        print(f"  {k:9s} {worst[k]:9.4f}  (t={worst_t[k]})")
    return worst


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    kw = {}
    for a in sys.argv[1:]:
        if a.startswith("--from="):
            kw["t0"] = int(a.split("=")[1])
        if a.startswith("--to="):
            kw["t1"] = int(a.split("=")[1])
        if a == "--ctick":
            kw["backend"] = "ctick"
    run(args[0], int(args[1]) if len(args) > 1 else 240,
        device=parity_battery.option("device"),
        oracle_bin=parity_battery.option("oracle"), **kw)
