"""Scenario battery: reference oracle vs the port's engine, reporting
per-scenario max divergence (the twin of the JAX package's
``tools/parity_battery.py``).  Run:

    python -m reinforcement_learning_torch.tools.parity_battery [T]
        [--backend=portable|kernel] [--device=cpu] [--oracle=PATH]
    python -m reinforcement_learning_torch.tools.parity_battery --long
        [T] [--control] [--device=cpu] [--oracle=PATH]

Each scenario teacher-starts from an explicit state and runs T ticks of
scripted controls through BOTH engines; errors are max over the trace.
``--backend=portable`` (default) is the portable engine, ``kernel`` the
arena-step kernel (the JAX tool's ``xla`` and ``pallas``).  On the card
unless ``--device=cpu``.
"""
import os
import sys

import numpy as np

from reinforcement_learning_torch.tools import parity


def C(**kw):
    return parity.CarInit(**kw)


def ctrl(T, n_cars=1, **cols):
    """columns: throttle steer pitch yaw roll jump boost handbrake; each a
    scalar or (T,) array."""
    names = ["throttle", "steer", "pitch", "yaw", "roll", "jump", "boost",
             "handbrake"]
    u = np.zeros((T, n_cars, 8), np.float32)
    for k, v in cols.items():
        u[:, :, names.index(k)] = np.asarray(v, np.float32).reshape(-1, 1)
    return u


def scenarios(T):
    S = parity.Scenario
    out = {}
    far_ball = dict(ball_pos=(3000.0, 3000.0, 93.15))

    out["drive_forward"] = S([C()], ctrl(T, throttle=1), **far_ball)
    out["drive_reverse"] = S([C()], ctrl(T, throttle=-1), **far_ball)
    out["steer_circle"] = S([C(vel=(500, 0, 0))],
                            ctrl(T, throttle=1, steer=1), **far_ball)
    out["powerslide"] = S([C(vel=(1400, 0, 0))],
                          ctrl(T, throttle=1, steer=1, handbrake=1),
                          **far_ball)
    out["boost_ground"] = S([C(boost=100)], ctrl(T, throttle=1, boost=1),
                            **far_ball)
    jump_u = ctrl(T, jump=np.r_[np.ones(12), np.zeros(T - 12)])
    out["jump_short"] = S([C()], jump_u, **far_ball)
    out["jump_held"] = S([C()], ctrl(T, jump=1), **far_ball)
    # double jump: press, release, press again
    dj = np.zeros(T); dj[:8] = 1; dj[20:24] = 1  # noqa: E702
    out["double_jump"] = S([C()], ctrl(T, jump=dj), **far_ball)
    # dodge: jump, then jump+pitch forward while airborne
    fl = np.zeros(T); fl[:6] = 1; fl[14:18] = 1  # noqa: E702
    pitch = np.zeros(T); pitch[14:18] = -1  # noqa: E702
    out["front_flip"] = S([C(vel=(300, 0, 0))],
                          ctrl(T, throttle=1, jump=fl, pitch=pitch),
                          **far_ball)
    # air control from a thrown state
    air = C(pos=(0, 0, 600), vel=(200, 0, 300), is_on_ground=False,
            has_jumped=True, air_time_since_jump=0.5, boost=100)
    out["air_pitch"] = S([air], ctrl(T, pitch=1), **far_ball)
    out["air_yaw"] = S([air], ctrl(T, yaw=1), **far_ball)
    out["air_roll"] = S([air], ctrl(T, roll=1), **far_ball)
    out["air_boost"] = S([air], ctrl(T, boost=1), **far_ball)
    out["air_drift"] = S([air], ctrl(T), **far_ball)
    # ball alone
    out["ball_drop"] = S([C(pos=(2000, 2000, 17.01))], ctrl(T),
                         ball_pos=(0, 0, 800))
    out["ball_bounce_spin"] = S([C(pos=(2000, 2000, 17.01))], ctrl(T),
                                ball_pos=(0, 0, 300),
                                ball_vel=(600, 0, -400),
                                ball_ang_vel=(0, 3, 0))
    out["ball_roll"] = S([C(pos=(2000, 2000, 17.01))], ctrl(T),
                         ball_pos=(0, 0, 93.15), ball_vel=(900, 200, 0))
    out["ball_wall"] = S([C(pos=(-2000, 2000, 17.01))], ctrl(T),
                         ball_pos=(3600, 0, 400), ball_vel=(1200, 0, 100))
    # car hits ball head-on
    out["car_ball_hit"] = S([C(vel=(1300, 0, 0), boost=100)],
                            ctrl(T, throttle=1),
                            ball_pos=(400, 0, 93.15))
    # --- curved-mesh scenarios (exercise the fillet ramps / corners that
    # only exist in the triangle-mesh arena)
    # ball rolled hard into the side wall: rides the floor->wall fillet up
    out["ball_ramp_wall"] = S([C(pos=(-2000, 2000, 17.01))], ctrl(T),
                              ball_pos=(3500, 0, 93.15),
                              ball_vel=(1800, 0, 0))
    # ball into the 45-degree corner wedge
    out["ball_corner"] = S([C(pos=(-2000, -2000, 17.01))], ctrl(T),
                           ball_pos=(2800, 3800, 93.15),
                           ball_vel=(1100, 1100, 0))
    # ball rolled into the goal mouth (crosses the goal opening geometry)
    out["ball_goal_mouth"] = S([C(pos=(-2000, 2000, 17.01))], ctrl(T),
                               ball_pos=(0, 4600, 93.15),
                               ball_vel=(0, 1300, 0))
    # car drives the floor->wall transition and onto the wall
    out["car_wall_ride"] = S([C(pos=(3300, 0, 17.01), vel=(1300, 0, 0),
                                boost=100)],
                             ctrl(T, throttle=1), **far_ball)
    # car dropped onto the resting ball: wheel rays must hit the ball
    # (suspension-grid dynamic overlay) so the car can balance on it
    out["car_on_ball"] = S([C(pos=(0.0, 0.0, 93.15 + 91.25 + 40.0),
                              is_on_ground=False)],
                           ctrl(T), ball_pos=(0.0, 0.0, 93.15))
    # two cars: bump course
    out["car_bump"] = S([C(vel=(1600, 0, 0)),
                         C(team=1, pos=(500, 0, 17.01),
                           fwd=(-1, 0, 0), right=(0, -1, 0))],
                        ctrl(T, n_cars=2, throttle=1), **far_ball)
    # demo: supersonic into stationary
    out["car_demo"] = S([C(vel=(2250, 0, 0), boost=100),
                         C(team=1, pos=(900, 0, 17.01),
                           fwd=(0, 1, 0), right=(-1, 0, 0))],
                        ctrl(T, n_cars=2, throttle=1, boost=1), **far_ball)
    return out


def option(name: str, default=None):
    """The value of ``--name=value`` on the command line, else
    ``default``."""
    for a in sys.argv[1:]:
        if a.startswith(f"--{name}="):
            return a.split("=", 1)[1]
    return default


def errors(ref, ours) -> dict:
    """The battery's columns for one scenario: max |oracle - ours| of car
    pos, vel, ang_vel and ball pos, vel over the trace, and the flags
    that differ in more than 5% of ticks."""
    gcf = parity.car_trace_field
    flag_names = ["is_on_ground", "has_jumped", "has_double_jumped",
                  "has_flipped", "is_supersonic", "is_demoed"]
    return dict(
        car_pos=float(np.abs(gcf(ref["cars"], "pos")
                             - gcf(ours["cars"], "pos")).max()),
        car_vel=float(np.abs(gcf(ref["cars"], "vel")
                             - gcf(ours["cars"], "vel")).max()),
        car_ang=float(np.abs(gcf(ref["cars"], "ang_vel")
                             - gcf(ours["cars"], "ang_vel")).max()),
        ball_pos=float(np.abs(ref["ball"][:, :3]
                              - ours["ball"][:, :3]).max()),
        ball_vel=float(np.abs(ref["ball"][:, 3:6]
                              - ours["ball"][:, 3:6]).max()),
        flags=[f for f in flag_names
               if np.mean(gcf(ref["cars"], f) != gcf(ours["cars"], f))
               > 0.05])


def main(backend: str = "portable", T: int = 120, device=None,
         oracle_bin=None) -> dict:
    """Prints the battery's table; returns scenario -> ``errors``."""
    if backend not in ("portable", "kernel"):
        raise ValueError(f"backend={backend!r}: use 'portable' or 'kernel'")
    scs = scenarios(T)
    names = list(scs)
    refs = parity.run_oracle([scs[n] for n in names], oracle_bin=oracle_bin)
    run = (parity.run_torch_kernel if backend == "kernel"
           else parity.run_torch)
    ours_all = run([scs[n] for n in names], device=device)
    print(f"{'scenario':20s} {'car_pos':>8s} {'car_vel':>8s} {'car_ang':>8s}"
          f" {'ball_pos':>9s} {'ball_vel':>9s} flags")
    out = {}
    for name, ref, ours in zip(names, refs, ours_all):
        e = out[name] = errors(ref, ours)
        print(f"{name:20s} {e['car_pos']:8.2f} {e['car_vel']:8.2f} "
              f"{e['car_ang']:8.3f} {e['ball_pos']:9.2f} "
              f"{e['ball_vel']:9.2f} {','.join(e['flags'])}")
    return out


def long_gate(T: int = 10_000, seed: int = 1234, control: bool = False,
              device=None, oracle_bin=None):
    """BASELINE #1: the 10k-tick seeded replay gate.

    Two cars + ball from a kickoff-like state, driven by seeded
    piecewise-constant pseudo-random controls, through oracle and the
    portable engine (``run_torch``); reports per-tick divergence against
    BallState::Matches margins (reference: Ball.h:38 -- pos 0.8uu, vel
    0.4, angvel 0.02) and the first tick each margin class is exceeded.
    A demolished car respawns at row 0 of the respawn table (the
    reference draws from its global RNG).

    ``control``: the chaos control, the reference against itself -- the
    FMA build (``parity.ORACLE_BIN_FMA``, or ``oracle_bin``) against the
    plain -O2 build ``tools/oracle/build/rs_oracle``
    (``parity.ORACLE_BIN_O2``), which ``tools/oracle/build.sh`` makes
    from the reference's sources; raises ``FileNotFoundError`` where that
    build is absent.
    """
    rng = np.random.default_rng(seed)
    # piecewise-constant random controls, held 12 ticks (human-rate input)
    n_seg = T // 12 + 1
    seg = np.zeros((n_seg, 2, 8), np.float32)
    seg[:, :, 0] = rng.choice([1.0, 1.0, 1.0, -1.0, 0.0], (n_seg, 2))
    seg[:, :, 1] = rng.uniform(-1, 1, (n_seg, 2))
    seg[:, :, 2] = rng.uniform(-1, 1, (n_seg, 2)) * (
        rng.random((n_seg, 2)) < 0.3)
    seg[:, :, 5] = rng.random((n_seg, 2)) < 0.06   # jump
    seg[:, :, 6] = rng.random((n_seg, 2)) < 0.35   # boost
    seg[:, :, 7] = rng.random((n_seg, 2)) < 0.08   # handbrake
    controls = np.repeat(seg, 12, axis=0)[:T]

    cars = [parity.CarInit(pos=(-2048, -2560, 17.01),
                           fwd=(0.7071, 0.7071, 0),
                           right=(-0.7071, 0.7071, 0), boost=33.3),
            parity.CarInit(team=1, pos=(2048, 2560, 17.01),
                           fwd=(-0.7071, -0.7071, 0),
                           right=(0.7071, -0.7071, 0), boost=33.3)]
    sc = parity.Scenario(cars=cars, controls=controls)
    if control:
        # CHAOS CONTROL: the reference compared against ITSELF, built
        # without FMA contraction -- same sources, a second
        # equally-valid float32 rounding.  Whatever divergence this shows
        # is the pure chaotic sensitivity of a 10k-tick two-car replay,
        # measured entirely inside the reference engine.
        ref = parity.run_oracle([sc], oracle_bin=parity.ORACLE_BIN_O2)[0]
        ours = parity.run_oracle([sc], oracle_bin=oracle_bin
                                 or parity.ORACLE_BIN_FMA)[0]
    else:
        ref = parity.run_oracle([sc], oracle_bin=oracle_bin)[0]
        ours = parity.run_torch([sc], device=device)[0]

    gcf = parity.car_trace_field
    margins = {"car_pos": (0.8, np.abs(gcf(ref["cars"], "pos")
                                       - gcf(ours["cars"], "pos"))),
               "car_vel": (0.4, np.abs(gcf(ref["cars"], "vel")
                                       - gcf(ours["cars"], "vel"))),
               "car_angvel": (0.02, np.abs(gcf(ref["cars"], "ang_vel")
                                           - gcf(ours["cars"], "ang_vel"))),
               "ball_pos": (0.8, np.abs(ref["ball"][:, :3]
                                        - ours["ball"][:, :3])),
               "ball_vel": (0.4, np.abs(ref["ball"][:, 3:6]
                                        - ours["ball"][:, 3:6]))}
    tag = "CHAOS CONTROL (oracle -O2 vs oracle -O2 -march=native)" \
        if control else "LONG GATE"
    print(f"{tag}: {T} ticks, seed {seed} "
          f"(BallState::Matches margins)")
    results = {}
    curves = {}
    for name, (margin, err) in margins.items():
        per_tick = err.reshape(err.shape[0], -1).max(-1)
        curves[name] = per_tick
        ok = per_tick <= margin
        first_bad = int(np.argmin(ok)) if not ok.all() else -1
        results[name] = dict(margin=margin,
                             within_pct=float(ok.mean() * 100),
                             first_exceeded=first_bad,
                             max_err=float(per_tick.max()))
        print(f"  {name:10s} margin={margin:<5} within={ok.mean()*100:6.2f}%"
              f" first_exceeded_tick={first_bad:6d}"
              f" max_err={per_tick.max():10.2f}")
    dump = os.environ.get("RLT_GATE_DUMP")
    if dump:
        np.savez(dump, **curves)
        print(f"  error curves -> {dump}")
    return results


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    device, oracle_bin = option("device"), option("oracle")
    if "--long" in sys.argv:
        long_gate(int(args[0]) if args else 10_000,
                  control="--control" in sys.argv, device=device,
                  oracle_bin=oracle_bin)
    else:
        main(option("backend", "portable"), int(args[0]) if args else 120,
             device=device, oracle_bin=oracle_bin)
