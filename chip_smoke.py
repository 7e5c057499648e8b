#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check its kernel.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, each of which must pass (nothing is caught):

1. build the arena-step kernel (csrc/arena_step.cu with cvec.cuh and
   facets.cuh) with nvcc for sm_90a, and print its launch shape (arenas
   per block, lanes per arena, blocks) and the 4-car kernel's registers,
   stack, spills and shared memory;
2. plane arena (``use_mesh=False``, ``dynamic_wheel_rays=False``): hold the
   kernel against its plain PyTorch version (ops/ctick.py) on the card at
   E=1024 arenas x 4 cars from five states: random env steps after
   kickoff, demolished cars respawning mid-step, opposing cars overlapping
   (bumps and demos), a car driving into the ball, and the ball and a car
   flying into the walls and the goal openings;
3. full fidelity (the default ``ArenaParams``: the facet arena and dynamic
   wheel rays): the same at E=1024 from seven crafted states, the ball
   into a floor fillet, a car driving up a back wall, a car flying side
   first into a back wall, the ball into a corner seam (more than 8 live
   contact candidates), the ball into the goal's net and crossbar, a car
   dropped on the ball and a car dropped on another car's roof; each
   shows that its contact happened where no true plane can stand in,
   reading the plain step's facet candidates or wheel rays;
4. the game modes (heatseeker and snowday at full fidelity, one
   heatseeker state on the plane arena too): the same at E=1024 from six
   crafted states, each of whose event the plain step shows in at least
   90% of arenas: the heatseeker ball steering in flight without contact,
   cars of both teams first touching it in the same tick (some within the
   minimum speed-up interval of the last hit), a deep back-wall hit that
   flips its target (at full fidelity and on the plane arena), a tumbling
   snowday puck dropped on the floor (ground stick), and a tilted puck
   into a side wall or a corner;
5. the collection paths, each with the kernel's launch count set to 0
   before and read after: ``RocketLeagueEnv`` 1024 x 2v2 and a
   ``PPOLearner`` at the bench widths in bf16, ``Trainer.collect`` for 24
   env steps, on the plane arena and at full fidelity; on each path's end
   state the kernel is held against the plain version, the plain run
   counting the work those inputs need for the kernel's bound
   (ops/opcount.py), the share of facet items, wheel-ray bands and car
   pairs the kernel's culls skip there is printed, and the kernel, the
   plain version and the collection are timed;
6. the main path: ``Trainer.train_iteration`` at bench.py's shape
   (bench_torch.py: 1024 x 2v2 soccar at full fidelity, 24 env steps,
   batch 50k, 2 epochs): one warm-up iteration, 3 timed ones (launches
   must be 24 per iteration, every metric finite, the parameters changed),
   and one more split into collect, values + GAE + Welford, and update;
7. one ``train_iteration`` each in heatseeker and snowday at the same
   width, with the end-state check, work count and timing of step 5;
8. [train_2v2], the canonical training program, built from the twin's
   own ``make_env``, ``auto_scale``, ``ppo_config``, ``trainer_config``
   and ``selfplay_config`` (512 x 2v2, the 13-term reward stack, the
   768-wide model at scale 1.5, AdamW, leaky ReLU, user metrics,
   self-play with skill matches, checkpoints), deviating from the example
   in two points it prints (the second timed iteration trains against an
   old version for certain; skill matches run every iteration): a warm-up
   that snapshots version 0 and 3 timed iterations with the launch count
   set to 0 before and read after (48 env steps each and 675 for each
   skill match), the old team's rows weighted 0, the bank's copy apart
   from the trained parameters, the ratings moved by the ELO rule for the
   goals counted, every metric finite; the kernel against the plain
   version on its end state (E=512) and on the skill match's (E=16), each
   timed with the plain version and its bound; one env step of 32 played arenas on the card
   against the plain path on the CPU; a checkpoint saved under ``build/``
   and resumed bit-equal into a fresh trainer through ``init_or_resume``,
   which trains one more iteration; then one iteration of the train_1v1
   twin (256 x 1v1) and the kernel on its end state (E=256, C=2);
9. [deploy], the trained policies into a match: the checkpoint step 8
   wrote (768 wide, leaky ReLU) into ``InferUnit`` on the card, its
   logits on 4,096 obs rows of a collection against the trainer's own
   fp32 forward; step 6's bench-shape ReLU model exported to the C++
   runtime (deploy/native), held on the host against ``InferUnit`` on the
   card and the port's CPU forward, deterministic actions differing only
   within the top-two margin; a scripted 2v2 session of 600 ticks at
   tick_skip 8 and action_delay 7 through the native bot server (the
   "add" command, four bots), through ``RLBotAdapter`` on the same
   runtime (equal controls at every tick) and on the card's
   ``InferUnit``; the converter's round trips (checkpoint -> .pt -> .npz
   and -> .lt -> .npz, into ``InferUnit``, logits bit-equal); the time of
   a decision on the card and on the host at batch 1 and 4 and of one
   ``RLBotAdapter.get_output`` that infers;
10. [geometry], the portable engine's arena geometry: the procedural
   soccar and hoops ``MeshGrid``s baked onto the card (``world.get_grid``);
   ``sphere_contacts`` for 1,024 balls, ``raycast`` for 1,024 x 4 x 4
   wheel rays and ``box_contacts`` for 4,096 car hitboxes, drawn from the
   states step 5's full-fidelity warm-up collection stepped from, and
   ``box_box_manifold`` on 4,096 overlapping car pairs, each on the card
   against the CPU and timed;
11. [portable], the portable physics engine (physics/step.py, car.py,
   contacts.py; no kernel): ``RocketLeagueEnv`` 1024 x 2v2 soccar with
   ``physics_backend="portable"`` steps once from the state step 5's
   full-fidelity collection ends in, with no kernel launch, timed; its
   ``arena_step`` on the card is held against the same code on the CPU
   (the same controls and per-tick respawn draws; ``compare``'s
   tolerances, at most 2% of arenas with a differing flag or a float
   beyond them); the tensor ops of a tick and of an env step;
12. [hoops]: one ``Trainer.train_iteration`` of 1024 x 2v2 hoops at the
   bench widths through ``physics_backend="auto"`` (the portable route;
   the kernel's launch count set to 0 before and read after must stay 0),
   split into collect, values + GAE + Welford and update, with its
   player-steps/s, goals and kickoffs, and the ms and tensor ops of an env
   step;
13. [ball_pred]: ``BallPredTracker(120)`` in hoops over the 1024 balls of
   step 12's end state (in flight after the hoops kickoff throws them
   up) on the card against the CPU (every entry to the tolerances above,
   at most 2% of balls off), and the time of an update;
14. the full-fidelity collection at 8 arenas on the card against the plain
   path on the CPU, deterministic actions, fp32;
15. [parallel], data parallelism (parallel/mesh.py): the main path
   (``initialize_distributed`` -> ``make_mesh`` -> ``shard_train_state``
   -> ``Trainer.train_iteration`` at bench shape) in spawned ranks, each
   with the kernel's launch count set to 0 before its first iteration and
   read after (24), against step 6's warm-up iteration (the unsharded run
   from the same seed): (a) one NCCL rank with all 1024 arenas; (b) two
   gloo ranks sharing the card (NCCL refuses two ranks on one card), 512
   arenas each; every parameter within tests/test_sharding.py's tolerance
   (rtol 2e-4, atol 2e-5) and reward_mean within 1e-4, every metric of
   the iteration and the return statistic within rtol 1e-3, atol 1e-5,
   the step count exact, the two ranks' parameters bit-equal; a second iteration timed per rank, the bytes
   all-reduced, the reset draw at the global width against the block's,
   the kernel per rank at E=512 (the ranks in turn), and on rank 0 the
   kernel against the plain version on its end state;
16. [parity], the parity instruments (tools/parity*.py twins) against
   the reference oracle (``tools/oracle/build-fma/rs_oracle``, run on the
   host in a thread beside the card's work): the 26-scenario battery of 240 ticks through the oracle, through
   the kernel route (``parity.run_torch_kernel``: tick_skip 1, action
   delay 0, the 24 one-car scenarios as one arena axis and the 2 two-car
   ones as another, the launch count set to 0 before each and read after,
   240 each) and through the portable engine (``parity.run_torch``, no
   kernel launch); the kernel at that launch shape held against its plain
   version at 5 ticks of each group to ``ops.ctick.DEFAULT_TOLERANCE``
   (1e-4, 1e-4) with no flag differing, timed with its bound at tick 120;
   PARITY.md's exact rows (driving, steering, powerslide, boost, jumps,
   the ball drop, the bump) within the BallState::Matches margins (pos
   0.8 uu, vel 0.4 uu/s, ang_vel 0.02 rad/s) with no flag differing on
   both routes, every other row printed beside PARITY.md's JAX figure;
   one teacher-forced ``front_flip`` through the kernel (239 launches);
17. [profile], the profilers (tools/profile_*.py twins): profile_split's
   six-part split of the main path at 1024 x 2v2 (env steps, rollout,
   inference, PPO update, one value pass, train_iteration) and
   profile_phys's kernel routes (plane arena, full fidelity) at 256 x 2v2,
   each line with the card's name and power limit.

Every kernel-vs-plain comparison uses ``ops.ctick.TOLERANCES`` (the
battery's: ``DEFAULT_TOLERANCE`` on every float) and allows at most one
arena (0.1% of 1024) with a differing boolean or integer, none in the
demo, car-car, game-mode and battery states.  Prints the card's name and
power limit, a ``kernels`` JSON line with one entry per configuration
(soccar plane arena, soccar full fidelity, heatseeker, snowday, the
train_2v2 path, the data-parallel path per rank, the two parity battery
groups), and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA card or without the repository beside it.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
E, CARS, T = 1024, 4, 24
SEED = 0
# H100 SXM (NVIDIA data sheet): HBM rate, fp32 rate outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

THRESHOLD_SHARE = 0.001   # arenas allowed a flipped boolean, random state


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def zero_counters():
    """Zero the port's tracer's counters (its spans stay off): what
    follows counts from zero."""
    from reinforcement_learning_torch.utils import tracing
    tracing.reset()


def counter(name: str) -> int:
    """The tracer's counter ``name`` (``kernel.launches``,
    ``shard.all_sum.calls``, ...) since ``zero_counters``."""
    from reinforcement_learning_torch.utils import tracing
    return tracing.summary()["counters"].get(name, 0)


def flatten(obj, prefix=""):
    import dataclasses
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


# Timers that a discrete event resets to a constant (a bump, a demo): an
# arena where one of them disagrees beyond its tolerance had the event on
# one side only, and counts with the arenas whose booleans differ.
EVENT_TIMERS = ("arena.cars.car_contact_cooldown",
                "arena.cars.demo_respawn_timer")


def compare(name, got, want, allowed_arenas, sides=("kernel", "plain"),
            floats_count=False, tolerance=None):
    """Hold kernel output ``got`` to the plain version's ``want`` field by
    field (``sides`` names the two in the messages), each float field to
    its ``ops.ctick.TOLERANCES`` entry, or every one to ``tolerance``
    (atol, rtol) where given.  Arenas where an
    integer or boolean field, or an event timer, differs are listed; at
    most ``allowed_arenas`` may, and their floats are not compared.  With
    ``floats_count``, an arena with a float beyond its tolerance is listed
    and counted with them instead of failing the check.  Returns the worst
    float deviation over the arenas that agree."""
    import torch
    from reinforcement_learning_torch.ops.ctick import (DEFAULT_TOLERANCE,
                                                        TOLERANCES)
    g, w = flatten(got), flatten(want)
    tols = {} if tolerance is not None else TOLERANCES
    default = tolerance if tolerance is not None else DEFAULT_TOLERANCE
    n = w["arena.tick_count"].shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=g["arena.tick_count"].device)
    flips = {}
    for k, a in w.items():
        if a.dtype.is_floating_point and k not in EVENT_TIMERS:
            continue
        if k in EVENT_TIMERS:
            atol, rtol = tols.get(k, default)
            d = ((g[k] - a).abs() > atol + rtol * a.abs()).reshape(n, -1)
            d = d.any(-1)
            for e in d.nonzero()[:, 0].tolist()[:4]:
                print(f"[{name}] arena {e}: {k} {sides[0]} "
                      f"{g[k][e].tolist()} {sides[1]} {a[e].tolist()}")
        else:
            d = (g[k] != a).reshape(n, -1).any(-1)
        if d.any():
            flips[k] = d.nonzero()[:, 0].tolist()
        bad |= d
    if floats_count:
        for k, a in w.items():
            if not a.dtype.is_floating_point or k in EVENT_TIMERS:
                continue
            atol, rtol = tols.get(k, default)
            d = (((g[k] - a).abs() > atol + rtol * a.abs())
                 | ~torch.isfinite(g[k])).reshape(n, -1).any(-1)
            if d.any():
                flips[k] = d.nonzero()[:, 0].tolist()
                e = flips[k][0]
                print(f"[{name}] arena {e}: {k} {sides[0]} "
                      f"{g[k][e].tolist()} {sides[1]} {a[e].tolist()}")
            bad |= d
    n_bad = int(bad.sum())
    print(f"[{name}] arenas with a differing boolean/int/event timer"
          f"{' or a float beyond tolerance' if floats_count else ''}: "
          f"{n_bad} {json.dumps(flips)}")
    if n_bad > allowed_arenas:
        fail(f"{name}: {n_bad} arenas differ in a boolean (allowed "
             f"{allowed_arenas})")
    ok = ~bad
    worst, err = {}, 0.0
    for k, a in w.items():
        if not a.dtype.is_floating_point:
            continue
        b = g[k]
        dev = (b[ok] - a[ok]).abs()
        worst[k] = float(dev.max()) if dev.numel() else 0.0
        err = max(err, worst[k])
        atol, rtol = tols.get(k, default)
        lim = atol + rtol * a[ok].abs()
        if bool((dev > lim).any()) or not bool(torch.isfinite(b).all()):
            at = int((dev - lim).reshape(dev.shape[0], -1).amax(-1).argmax())
            e = int(ok.nonzero()[at, 0])
            fail(f"{name}: {k} off by {worst[k]:.3g} (atol {atol}, rtol "
                 f"{rtol}); arena {e}: {sides[0]} {b[e].tolist()} "
                 f"{sides[1]} {a[e].tolist()}")
    print(f"[{name}] worst |{sides[0]} - {sides[1]}| per field: "
          + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    return err


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def small_collect_agrees(dev, params):
    """3 deterministic env steps at 8 arenas on ``dev`` (the kernel path)
    against the plain path on the CPU, from the same kickoff and weights."""
    import torch
    from reinforcement_learning_torch.device import tree_map
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    small = PPOConfig(policy_layers=(64, 64), critic_layers=(64, 64),
                      shared_head_layers=(64,), half_precision=False,
                      deterministic=True)
    trainers = {}
    for key, where in (("plain", "cpu"), ("kernel", dev)):
        senv = RocketLeagueEnv(EnvConfig(num_envs=8, team_size=2,
                                         arena=params, device=where))
        trainers[key] = Trainer(senv, small, TrainerConfig(
            ts_per_itr=32, random_seed=SEED))
    trainers["kernel"].learner.load_state_dict(
        trainers["plain"].learner.state_dict())
    start = trainers["plain"].init(SEED)
    plain = trainers["plain"].collect(start, 3)[1]
    kern = trainers["kernel"].collect(
        tree_map(lambda t: t.to(dev), start), 3)[1]
    for k in ("obs", "final_obs", "reward", "old_logp"):
        d = float((kern[k].cpu() - plain[k]).abs().max())
        print(f"[small] {dev} vs cpu {k}: max |diff| {d:.3g}")
        if d > 2e-3:
            fail(f"small collection: {k} differs by {d:.3g} (tol 2e-3)")
    for k in ("action", "terminal", "mask"):
        if not torch.equal(kern[k].cpu(), plain[k]):
            fail(f"small collection: {k} differs between {dev} and CPU")


class States:
    """Crafted kernel-vs-plain states, made on the card from one seeded
    generator on top of a random state of the env."""

    def __init__(self, dev, gen):
        self.dev, self.gen = dev, gen

    def u(self, lo, hi):
        import torch
        return lo + (hi - lo) * torch.rand(E, generator=self.gen,
                                           device=self.dev)

    def copy(self, phys):
        from reinforcement_learning_torch.device import tree_map
        return tree_map(lambda t: t.clone(), phys)

    def demo(self, phys):
        import torch
        phys = self.copy(phys)
        cars = phys.arena.cars
        demoed = torch.zeros_like(cars.is_demoed)
        demoed[:, 0] = demoed[:, 3] = True
        ticks = torch.randint(1, 10, (E, CARS), generator=self.gen,
                              device=self.dev)
        cars.is_demoed = demoed
        cars.demo_respawn_timer = torch.where(demoed, ticks / 120.0, 0.0)
        return phys

    def overlap(self, phys):
        """Car 0 drives into car 2 and car 3 into car 1, nearly head-on,
        hitboxes a few uu into each other; half the attackers are
        supersonic."""
        import torch
        from reinforcement_learning_torch import maths
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u
        for att, vic, y0 in ((0, 2, -1500.0), (3, 1, 1500.0)):
            x0 = u(-2000, 2000)
            ya, yv = u(-0.15, 0.15), torch.pi + u(-0.15, 0.15)
            fast = torch.arange(E, device=self.dev) % 2 == 0
            speed = torch.where(fast, 2250.0, 900.0)
            z = torch.full_like(x0, 17.0)
            cars.pos[:, att] = torch.stack([x0, torch.full_like(x0, y0), z],
                                           -1)
            cars.pos[:, vic] = torch.stack(
                [x0 + u(138, 144), y0 + u(-20, 20), z], -1)
            cars.vel[:, att] = torch.stack(
                [speed * torch.cos(ya), speed * torch.sin(ya), 0 * z], -1)
            cars.vel[:, vic] = torch.stack([-300 + 0 * z, u(-100, 100),
                                            0 * z], -1)
            cars.rot[:, att] = maths.euler_to_rotmat(ya)
            cars.rot[:, vic] = maths.euler_to_rotmat(yv)
            cars.ang_vel[:, att] = 0.0
            cars.ang_vel[:, vic] = 0.0
            cars.is_supersonic[:, att] = fast
            cars.is_demoed[:, att] = cars.is_demoed[:, vic] = False
            cars.is_on_ground[:, att] = cars.is_on_ground[:, vic] = True
        return phys

    def car_ball(self, phys):
        """Car 0 drives into the resting ball from about 150 uu behind it,
        a little off centre; the ball anywhere on the field."""
        import torch
        phys = self.copy(phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = self.u
        bx, by = u(-3000, 3000), u(-4000, 4000)
        ball.pos = torch.stack([bx, by, torch.full_like(bx, 93.15)], -1)
        ball.vel = torch.zeros_like(ball.vel)
        ball.ang_vel = torch.zeros_like(ball.ang_vel)
        cars.pos[:, 0] = torch.stack([bx - 150 + u(-10, 20), by + u(-30, 30),
                                      torch.full_like(bx, 17.0)], -1)
        cars.vel[:, 0] = torch.stack([u(800, 1600), 0 * bx, 0 * bx], -1)
        cars.rot[:, 0] = torch.eye(3, device=self.dev)
        cars.ang_vel[:, 0] = 0.0
        cars.is_demoed[:, 0] = False
        return phys

    def walls(self, phys):
        """The ball flies into a side wall (even arenas) or a back wall,
        into the goal where it meets the opening; car 1 drives into a side
        wall and car 2 falls onto the floor from above."""
        import torch
        from reinforcement_learning_torch import maths
        phys = self.copy(phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = self.u
        sign = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        side = torch.arange(E, device=self.dev) % 2 == 0
        near = sign * (4000.0 - u(0, 40))
        across = u(-1500, 1500)
        ball.pos = torch.stack([torch.where(side, near, across),
                                torch.where(side, u(-3000, 3000),
                                            near * 1.25),
                                u(93.15, 1200)], -1)
        fast = sign * u(500, 2000)
        ball.vel = torch.stack([torch.where(side, fast, u(-300, 300)),
                                torch.where(side, u(-300, 300), fast),
                                u(-300, 300)], -1)
        ball.ang_vel = torch.stack([u(-2, 2), u(-2, 2), u(-2, 2)], -1)
        wall_x = -sign * (4096.0 - 80.0 - u(0, 30))
        cars.pos[:, 1] = torch.stack([wall_x, u(-3000, 3000),
                                      torch.full_like(wall_x, 17.0)], -1)
        cars.vel[:, 1] = torch.stack([-sign * u(500, 1500), u(-200, 200),
                                      0 * wall_x], -1)
        cars.rot[:, 1] = maths.euler_to_rotmat(
            torch.where(sign > 0, torch.pi, 0.0) + u(-0.3, 0.3))
        cars.ang_vel[:, 1] = 0.0
        cars.pos[:, 2, 2] = u(30, 120)
        cars.vel[:, 2, 2] = u(-600, -100)
        cars.is_demoed[:, 1] = cars.is_demoed[:, 2] = False
        return phys

    # -- full fidelity ------------------------------------------------------
    def _still_ball(self, phys):
        import torch
        phys = self.copy(phys)
        phys.arena.ball.ang_vel = torch.zeros_like(phys.arena.ball.ang_vel)
        return phys

    def fillet_ball(self, phys):
        """The ball flies into the floor fillet of a side wall (tests/
        test_ctick.py:258, moved a step closer): it must bounce up."""
        import torch
        phys = self._still_ball(phys)
        ball = phys.arena.ball
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        ball.pos = torch.stack([sx * u(3960, 3980), u(-3000, 3000),
                                u(120, 130)], -1)
        ball.vel = torch.stack([sx * u(800, 1000), u(-100, 100),
                                u(-350, -250)], -1)
        return phys

    def wall_drive(self, phys):
        """Car 1 drives up a back wall on its wheels (y = +-5103, beside
        the goal, 450-900 uu up, facing up the wall), throttle on."""
        import torch
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        z = torch.zeros_like(sy)
        cars.pos[:, 1] = torch.stack([sx * u(1300, 2500), sy * 5103.0,
                                      u(450, 900)], -1)
        cars.vel[:, 1] = torch.stack([u(-200, 200), z, u(200, 600)], -1)
        cars.ang_vel[:, 1] = 0.0
        # columns forward, right, up: forward up the wall, up = -y on the
        # y+ wall and +y on the y- wall
        cars.rot[:, 1] = torch.stack([
            torch.stack([z, -sy, z], -1),
            torch.stack([z, z, -sy], -1),
            torch.stack([z + 1.0, z, z], -1)], -2)
        cars.is_demoed[:, 1] = False
        return phys

    def box_wall(self, phys, half_width):
        """Car 2 flies side first into a back wall beside the goal, its
        hitbox (``half_width`` to either side) 5-25 uu from the wall at
        1000-1500 uu/s, with no world contact normal recorded yet."""
        import torch
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        z = torch.zeros_like(sy)
        cars.pos[:, 2] = torch.stack(
            [sx * u(1300, 2500), sy * (5120.0 - half_width - u(5, 25)),
             u(300, 1000)], -1)
        cars.vel[:, 2] = torch.stack([z, sy * u(1000, 1500), z], -1)
        cars.ang_vel[:, 2] = 0.0
        cars.rot[:, 2] = torch.eye(3, device=self.dev)
        cars.world_contact_normal[:, 2] = 0.0
        cars.is_demoed[:, 2] = False
        return phys

    def corner_ball(self, phys):
        """The ball flies fast and low into a corner where a side wall
        meets a corner wall, at the seam of their floor fillets, where
        the ball sees more than 8 live facet candidates."""
        import torch
        phys = self._still_ball(phys)
        ball = phys.arena.ball
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        ball.pos = torch.stack([sx * u(3920, 3960), sy * u(3830, 3900),
                                u(100, 140)], -1)
        ball.vel = torch.stack([sx * u(1500, 2500), sy * u(1500, 2500),
                                u(-600, -300)], -1)
        return phys

    def goal_mouth(self, phys):
        """The ball flies into the goal: onto the back net (even arenas)
        or into the crossbar (odd), at both ends."""
        import torch
        phys = self._still_ball(phys)
        ball = phys.arena.ball
        u = self.u
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        net = torch.arange(E, device=self.dev) % 2 == 0
        ball.pos = torch.stack([
            torch.where(net, u(-700, 700), u(-600, 600)),
            sy * torch.where(net, u(5830, 5860), u(5040, 5070)),
            torch.where(net, u(150, 500), u(690, 720))], -1)
        ball.vel = torch.stack([u(-50, 50), sy * u(1000, 1500),
                                u(-100, 0)], -1)
        return phys

    def car_on_ball(self, phys):
        """Car 0 dropped onto the resting ball (tests/test_ctick.py:305):
        its wheel rays stand on the ball."""
        import torch
        phys = self._still_ball(phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = self.u
        bx, by = u(-3000, 3000), u(-4000, 4000)
        ball.pos = torch.stack([bx, by, torch.full_like(bx, 93.15)], -1)
        ball.vel = torch.zeros_like(ball.vel)
        # the rear wheels' rays reach the ball's top from 195-198 uu
        cars.pos[:, 0] = torch.stack([bx + u(-4, 4), by + u(-4, 4),
                                      u(195, 198)], -1)
        cars.vel[:, 0] = 0.0
        cars.ang_vel[:, 0] = 0.0
        cars.rot[:, 0] = torch.eye(3, device=self.dev)
        cars.is_demoed[:, 0] = False
        return phys

    def car_on_car(self, phys):
        """Car 1 dropped onto car 0's roof, 70-80 uu up: its wheel rays
        reach car 0's box (the roof at 55.8 uu) but not the floor.  Car 1
        is pitched and rolled by 3-7 degrees: two level boxes tie the
        separating-axis test between their up axes, and the last ulp then
        picks the reference face."""
        import torch
        from reinforcement_learning_torch import maths
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u

        def tilt():
            return torch.where(u(0, 1) > 0.5, 1.0, -1.0) * u(0.05, 0.12)
        x0, y0, yaw = u(-3000, 3000), u(-4000, 4000), u(-3, 3)
        cars.pos[:, 0] = torch.stack([x0, y0, torch.full_like(x0, 17.0)], -1)
        cars.pos[:, 1] = torch.stack([x0 + u(-8, 8), y0 + u(-8, 8),
                                      u(70, 80)], -1)
        cars.rot[:, 0] = maths.euler_to_rotmat(yaw)
        cars.rot[:, 1] = maths.euler_to_rotmat(yaw + u(-0.3, 0.3), tilt(),
                                               tilt())
        for c in (0, 1):
            cars.vel[:, c] = 0.0
            cars.ang_vel[:, c] = 0.0
            cars.is_demoed[:, c] = False
        return phys


    # -- game modes ---------------------------------------------------------
    def _sign(self):
        import torch
        return torch.where(self.u(0, 1) > 0.5, 1.0, -1.0)

    def hs_flight(self, phys):
        """The heatseeker ball in flight 800-1500 uu up, seeking either
        goal at up to 1500 uu/s, its last hit 0-3 s ago."""
        import torch
        phys = self._still_ball(phys)
        ball, u = phys.arena.ball, self.u
        ball.pos = torch.stack([u(-2500, 2500), u(-3000, 3000),
                                u(800, 1500)], -1)
        ball.vel = torch.stack([u(-1500, 1500), u(-1500, 1500),
                                u(-300, 300)], -1)
        ball.hs_y_target_dir = self._sign()
        ball.hs_target_speed = u(2900, 4500)
        ball.hs_time_since_hit = u(0, 3)
        return phys

    def hs_touch(self, phys):
        """Car 0 (blue) and car 2 (orange) drive at 1100-1300 uu/s into
        the resting heatseeker ball from either side, 147-157 uu from its
        centre, so that both first touch it in the step's first tick (a
        seeking ball at rest starts at 30% of its target speed); the ball
        idle or seeking, its last hit 0-2 s ago (within the minimum
        speed-up interval or after it); cars 1 and 3 parked out of the
        way; every car's controls released.  The cars come in 5-20 uu off
        the ball's line and up to 0.1 rad off its axis: on the line, the
        friction direction of the contact is rounding noise (ROADMAP
        Queue 3)."""
        import torch
        from reinforcement_learning_torch import maths
        phys = self._still_ball(phys)
        cars, ball, u = phys.arena.cars, phys.arena.ball, self.u
        bx, by = u(-2500, 2500), u(-3000, 3000)
        z = torch.zeros_like(bx)
        ball.pos = torch.stack([bx, by, z + 93.15], -1)
        ball.vel = torch.zeros_like(ball.vel)
        ball.hs_y_target_dir = torch.floor(u(0, 3)).clamp(max=2) - 1
        ball.hs_target_speed = u(2900, 4500)
        ball.hs_time_since_hit = u(0, 2)
        for c, side in ((0, -1.0), (2, 1.0)):
            yaw = (torch.pi if side > 0 else 0.0) + u(-0.1, 0.1)
            speed = u(1100, 1300)
            cars.pos[:, c] = torch.stack(
                [bx + side * u(147, 157), by + self._sign() * u(5, 20),
                 z + 17.0], -1)
            cars.vel[:, c] = torch.stack([speed * torch.cos(yaw),
                                          speed * torch.sin(yaw), z], -1)
            cars.rot[:, c] = maths.euler_to_rotmat(yaw)
        far = -torch.sign(bx) * 3500.0
        cars.pos[:, 1] = torch.stack([far, by, z + 17.0], -1)
        cars.pos[:, 3] = torch.stack([far, by - torch.sign(by) * 800.0,
                                      z + 17.0], -1)
        # no jump, flip or control left over from the random steps
        for f in ("is_jumping", "has_jumped", "has_double_jumped",
                  "has_flipped", "is_flipping", "is_auto_flipping",
                  "is_demoed"):
            getattr(cars, f)[:] = False
        for f in ("jump_time", "flip_time", "air_time",
                  "air_time_since_jump", "auto_flip_timer", "ang_vel",
                  "controls", "last_controls"):
            getattr(cars, f)[:] = 0.0
        cars.vel[:, 1] = cars.vel[:, 3] = 0.0
        return phys

    def hs_backwall(self, phys):
        """The heatseeker ball 40-60 uu short of a back wall beside the
        goal (|x| 1300-2600, 300-900 uu up), flying into it at 1500-2500
        uu/s while it seeks that wall's goal."""
        import torch
        phys = self._still_ball(phys)
        ball, u = phys.arena.ball, self.u
        sy = self._sign()
        ball.pos = torch.stack([self._sign() * u(1300, 2600),
                                sy * (5120.0 - 91.25 - u(40, 60)),
                                u(300, 900)], -1)
        ball.vel = torch.stack([u(-200, 200), sy * u(1500, 2500),
                                u(-100, 100)], -1)
        ball.hs_y_target_dir = sy
        ball.hs_target_speed = u(2000, 4000)
        return phys

    def _puck(self, phys):
        """A copy with the puck tilted up to 0.5 rad and spinning; also
        returns the height at which its rim meets the floor."""
        import torch
        from reinforcement_learning_torch import maths
        phys = self.copy(phys)
        ball, u = phys.arena.ball, self.u
        ball.rot = maths.euler_to_rotmat(u(-3, 3), u(-0.5, 0.5),
                                         u(-0.5, 0.5))
        ball.ang_vel = torch_stack3(u(-3, 3), u(-3, 3), u(-3, 3))
        az = ball.rot[:, 2, 2].abs()
        rest = 114.25 * torch.sqrt(1 - az * az) + 31.25 * az
        return phys, rest

    def snow_floor(self, phys):
        """A tumbling snowday puck dropped at 300 uu/s on the floor of the
        midfield from 1-5 uu above it."""
        phys, rest = self._puck(phys)
        u = self.u
        phys.arena.ball.pos = torch_stack3(u(-2500, 2500), u(-3500, 3500),
                                           rest + u(1, 5))
        phys.arena.ball.vel = torch_stack3(u(-500, 500), u(-500, 500),
                                           u(-320, -280))
        return phys

    def snow_wall(self, phys):
        """The tilted, spinning puck slides into a side wall (even arenas)
        or into a corner (odd) at an angle, 1-5 uu above the floor."""
        import torch
        phys, rest = self._puck(phys)
        u = self.u
        sx, sy = self._sign(), self._sign()
        side = torch.arange(E, device=self.dev) % 2 == 0
        phys.arena.ball.pos = torch_stack3(
            sx * torch.where(side, u(3940, 3960), u(3880, 3895)),
            torch.where(side, u(-2000, 2000), sy * u(3985, 3995)),
            rest + u(1, 5))
        phys.arena.ball.vel = torch_stack3(
            sx * torch.where(side, u(1000, 1400), u(800, 1000)),
            torch.where(side, u(-600, 600), sy * u(800, 1000)),
            u(-50, 0))
        return phys


def ptxas_resources(log, num_cars):
    """The ptxas lines of the ``num_cars``-car kernel in nvcc's -v output:
    registers, stack frame, spill stores and loads."""
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines)
          if "entry function" in ln and f"ILi{num_cars}E" in ln]
    if not at:
        fail(f"no ptxas lines for the {num_cars}-car kernel")
    info = " ".join(lines[at[0] + 1:at[0] + 4])
    num = {k: re.search(rf"(\d+) {k}", info) for k in (
        "registers", "bytes stack frame", "bytes spill stores",
        "bytes spill loads")}
    if not all(num.values()):
        fail(f"unparsed ptxas lines: {info}")
    return ", ".join(f"{m.group(1)} {k}" for k, m in num.items())


def kernel_skips(phys, consts):
    """The share of the work the kernel's culls skip on ``phys`` (its
    first tick, the torch forms of the culls in physics/facet_arena.py):
    (body, band) facet items of the cars and the ball, (wheel ray, band)
    tests, and the share of car pairs whose box-box test finds a contact
    and so reach the pair solver."""
    import numpy as np
    import torch
    from reinforcement_learning_torch import constants as C
    from reinforcement_learning_torch.physics import box_box
    from reinforcement_learning_torch.physics import facet_arena as fa
    cars, ball = phys.arena.cars, phys.arena.ball
    # the break gaps and ray lengths as ops/arena_step.py packs them
    he = consts.half_extents
    brk = C.CONTACT_BREAK_FRAC * (float(np.linalg.norm(he)) + float(
        np.linalg.norm(consts.hitbox_offset)))
    radius = consts.mut.ball_radius
    ball_brk = C.CONTACT_BREAK_FRAC * (radius + C.SPHERE_BOUND_EXTRA)
    ray_len = [r + C.BTVehicle.MAX_SUSPENSION_TRAVEL + rad
               - C.BTVehicle.SUSPENSION_SUBTRACTION * C.BT_TO_UU
               for r, rad in zip(consts.sus_rest, consts.wheel_radii)]
    rot = cars.rot                                   # (E, C, 3, 3)
    R = tuple(tuple(rot[..., i, j] for j in range(3)) for i in range(3))
    off = torch.tensor(consts.hitbox_offset, device=rot.device)
    bc = cars.pos + torch.einsum("ecij,j->eci", rot, off)
    hc = tuple(h - C.MESH_COLLISION_MARGIN for h in he)
    box = fa.box_band_culled(bc[..., 0], bc[..., 1], bc[..., 2], R, hc,
                             fa.box_dist_margin(he), brk)
    items = [box.reshape(-1)]
    if consts.game_mode != "snowday":
        items.append(fa.sphere_band_culled(
            ball.pos[:, 0], ball.pos[:, 1], ball.pos[:, 2], radius,
            ball_brk).reshape(-1))
    items = torch.cat(items)
    rays = []
    for w in range(4):
        hard = cars.pos + torch.einsum(
            "ecij,j->eci", rot,
            torch.tensor(consts.wheel_offsets[w], device=rot.device))
        rays.append(fa.ray_band_culled(hard[..., 0], hard[..., 1],
                                       hard[..., 2], ray_len[w]))
    rays = torch.stack(rays)
    alive = ~cars.is_demoed
    bc_bt = bc * C.UU_TO_BT
    pairs = []
    for i in range(CARS):
        for j in range(i + 1, CARS):
            mf = box_box.box_box_clamped_components(
                tuple(bc_bt[:, i, k] for k in range(3)),
                tuple(tuple(rot[:, i, a, b] for b in range(3))
                      for a in range(3)), consts.he_eff_bt,
                tuple(bc_bt[:, j, k] for k in range(3)),
                tuple(tuple(rot[:, j, a, b] for b in range(3))
                      for a in range(3)), consts.he_eff_bt)
            pairs.append(mf["overlap"] & alive[:, i] & alive[:, j])
    pairs = torch.stack(pairs)
    return {"band_items_skipped": float(items.float().mean()),
            "ray_band_tests_skipped": float(rays.float().mean()),
            "car_pairs_solved": float(pairs.float().mean())}


def torch_stack3(x, y, z):
    import torch
    return torch.stack([x, y, z], -1)


class SnowContacts:
    """While open, records per arena whether the plain version's snowday
    puck contact (``ctick._resolve_ball_world_snowday``) touched the floor
    or a wall at any tick."""

    def __enter__(self):
        import torch
        from reinforcement_learning_torch.ops import ctick
        self.floor = self.wall = None
        self._fn = ctick._resolve_ball_world_snowday

        def spy(*args, **kw):
            out = self._fn(*args, **kw)
            touch, n = out[3], out[4]
            # the mean of the live rows' normals: only the floor's points
            # up, only walls' have a horizontal part
            floor = touch & (n[2] > 0.1)
            wall = touch & (torch.sqrt(n[0] * n[0] + n[1] * n[1]) > 0.1)
            self.floor = floor if self.floor is None else self.floor | floor
            self.wall = wall if self.wall is None else self.wall | wall
            return out
        ctick._resolve_ball_world_snowday = spy
        return self

    def __exit__(self, *exc):
        from reinforcement_learning_torch.ops import ctick
        ctick._resolve_ball_world_snowday = self._fn


class LiveCandidates:
    """While open, records the facet-arena contact candidates that the
    plain version's 4-slot retention (``ctick.keep_diverse4``) sees live:
    per arena, the most at any tick for the ball (``ball``, (E,)) and for
    each car (``cars``, (C, E)); None where no retention ran."""

    def __enter__(self):
        import torch
        from reinforcement_learning_torch.ops import ctick
        self.ball = self.cars = None
        self._keep = ctick.keep_diverse4

        def spy(d, pays, px, py, pz):
            n = (d < 1e30).sum(0)
            if n.dim() == 1:
                self.ball = n if self.ball is None else torch.maximum(
                    self.ball, n)
            else:
                self.cars = n if self.cars is None else torch.maximum(
                    self.cars, n)
            return self._keep(d, pays, px, py, pz)
        ctick.keep_diverse4 = spy
        return self

    def __exit__(self, *exc):
        from reinforcement_learning_torch.ops import ctick
        ctick.keep_diverse4 = self._keep


def kernel_vs_plain(name, phys, params, teams, ctl, r, allowed, check=None):
    """One env step of the kernel and of the plain version on the card from
    ``phys``; ``check(phys, got, live)`` shows the state's contact
    happened, ``live`` being the plain step's ``LiveCandidates`` (with its
    ``SnowContacts`` as ``live.snow`` and its output as ``live.want``).
    Prints the kernel's time on the state.  Returns the worst float
    deviation."""
    import torch
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.ops import ctick
    consts = A._consts(params, tuple(int(t) for t in teams))
    got = A.arena_step(phys, ctl, r, params, teams)
    with LiveCandidates() as live, SnowContacts() as live.snow:
        want = ctick.arena_step_reference(phys, ctl, r, consts)
    live.want = want
    torch.cuda.synchronize()
    if check is not None:
        check(phys, got, live)
    err = compare(name, got, want, allowed)
    ms = cuda_ms(lambda: A.arena_step(phys, ctl, r, params, teams), reps=5)
    print(f"[{name}] arena_step on this state: {ms:.4f} ms (pack, kernel, "
          "unpack; CUDA events)")
    return err


def bench_ppo_config():
    from bench_torch import BENCH_PPO
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    return PPOConfig(**BENCH_PPO)


def check_traj(label, env, traj, T_steps):
    import torch
    P = CARS
    shapes = dict(obs=(T_steps, E, P, env.obs_size),
                  mask=(T_steps, E, P, 90), action=(T_steps, E, P),
                  old_logp=(T_steps, E, P), reward=(T_steps, E, P),
                  terminal=(T_steps, E), final_obs=(T_steps, E, P,
                                                    env.obs_size),
                  goal=(T_steps, E), touch=(T_steps, E, P))
    for k, shp in shapes.items():
        v = traj[k]
        if tuple(v.shape) != shp:
            fail(f"{label}: traj[{k!r}] shape {tuple(v.shape)} != {shp}")
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            fail(f"{label}: traj[{k!r}] holds NaN or inf")
    chosen_ok = torch.gather(traj["mask"], -1, traj["action"][..., None])
    if not bool(chosen_ok.all()):
        fail(f"{label}: an action outside its mask was sampled")
    if not bool((traj["old_logp"] <= 0).all()):
        fail(f"{label}: log-probabilities above 0")


def drive_path(label, env, params, card, gen, T_steps, record=False):
    """Collect ``T_steps`` env steps of 1024 x 2v2 on ``env`` through the
    normal entry points, with the kernel's launch count set to 0 just
    before and read just after; check the trajectory; then ``end_state``
    on the state it ends in.  Returns the path's ``kernels`` entry; with
    ``record``, also the ball and car positions and rotations of every
    state the warm-up collection stepped from (``"positions"``) and the
    env state the timed collection ends in (``"played"``)."""
    import torch
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    trainer = Trainer(env, bench_ppo_config(),
                      TrainerConfig(ts_per_itr=100_000, random_seed=SEED))
    if trainer.steps_per_itr != T:
        fail(f"steps_per_itr {trainer.steps_per_itr} != {T}")
    print(f"[{label}] params {trainer.learner.param_counts()}, arena "
          f"use_mesh={params.use_mesh} "
          f"dynamic_wheel_rays={params.dynamic_wheel_rays}")
    tstate = trainer.init(SEED)
    seen = []
    if record:
        step = env.step

        def recording(st, act):
            seen.append((st.phys.ball.pos.clone(), st.phys.cars.pos.clone(),
                         st.phys.cars.rot.clone()))
            return step(st, act)
        env.step = recording
    tstate, _ = trainer.collect(tstate, T_steps)            # warm-up
    if record:
        del env.step
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    tstate, traj = trainer.collect(tstate, T_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter("kernel.launches")
    if launches != T_steps:
        fail(f"{label}: arena_step launched {launches} times in {T_steps} "
             "env steps")
    check_traj(label, env, traj, T_steps)
    steps_per_s = T_steps * E * CARS / wall
    print(f"[{label}] collect: {T_steps} env steps x {E} arenas x {CARS} "
          f"players in {wall:.3f} s = {steps_per_s:.0f} player-steps/s; "
          f"launches {launches}; goals {int(traj['goal'].sum())}, touches "
          f"{int(traj['touch'].sum())}")
    entry = {"launches": launches,
             **end_state(label, trainer, tstate, traj["action"][-1], params,
                         card, gen)}
    if record:
        entry["positions"] = [torch.cat(x) for x in zip(*seen)]
        entry["played"] = tstate.env_states
    return entry


def raw_kernel(lib, phys, ctl, r, params, teams, tick_skip=8,
               action_delay=7):
    """(a function launching the kernel alone on the packed buffers of
    ``phys``, the bytes the launch reads and writes)."""
    import torch
    from reinforcement_learning_torch.ops import arena_step as A
    n, P = phys.cars.boost.shape
    f, i, u = A._pack(phys)
    ctl_k = ctl.permute(2, 1, 0).contiguous()
    r_k = r.transpose(0, 1).contiguous()
    outs = [torch.empty_like(x) for x in (f, i, u)]
    prm = A.pack_params(params, teams)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        e = lib.arena_step_launch(
            prm.ctypes.data, prm.nbytes, f.data_ptr(), i.data_ptr(),
            u.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), ctl_k.data_ptr(), r_k.data_ptr(), n, P,
            tick_skip, action_delay, stream)
        if e:
            fail(f"kernel launch error {e}")
    nbytes = sum(x.numel() * x.element_size()
                 for x in (f, i, u, *outs, ctl_k, r_k))
    return raw, nbytes


def bound(nbytes, ops):
    """(bound_ms, bound_by, bytes_ms, ops_ms): the larger of the bytes
    over the memory rate and the fp32 ops over the fp32 rate."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms,
            ops_ms)


def end_state(label, trainer, tstate, actions, params, card, gen):
    """Hold the kernel to the plain version on the state a path ends in,
    stepped with ``actions``, the plain run counting the work its inputs
    need (the kernel's bound), and time the kernel, the plain version, the
    policy sample and the env step there.  Returns ms, plain_ms, bound_ms,
    bound_by and end_err."""
    import torch
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.ops import ctick, opcount
    env = trainer.env
    teams = tuple(int(t) for t in env.teams_np)
    consts = A._consts(params, teams)
    lib = A._library()
    phys = tstate.env_states.phys
    n, P = phys.cars.boost.shape
    ctl = env.action_parser.parse(actions)
    r = torch.randint(0, 4, (n, P), generator=gen,
                      device=phys.cars.pos.device, dtype=torch.int32)
    work = opcount.step_work(phys, ctl, r, consts)
    got = A.arena_step(phys, ctl, r, params, teams)
    torch.cuda.synchronize()
    err = compare(f"{label}_end_state", got, work.out, 1)
    if params.use_mesh:
        print(f"[{label}] the kernel's culls on this state's first tick: "
              + json.dumps(kernel_skips(phys, consts)))
    print(f"[{label}] fp32 ops per env step, needed / branch-free: "
          + json.dumps({k: [float(f"{n:.4g}"), float(f"{b:.4g}")]
                        for k, (n, b) in work.by_gate.items()}))

    # kernel time alone, on the path's end state and shapes
    raw, nbytes = raw_kernel(lib, phys, ctl, r, params, teams)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = cuda_ms(raw, reps=10, warmup=2)
    wrapper_ms = cuda_ms(lambda: A._launch(lib, phys, ctl, r, params, teams,
                                           8, 7, stream), reps=5)
    plain_ms = cuda_ms(lambda: ctick.arena_step_reference(phys, ctl, r,
                                                          consts),
                       reps=1, warmup=0)
    flat_obs = tstate.obs.reshape(n * P, -1)
    flat_mask = tstate.masks.reshape(n * P, -1)
    policy_ms = cuda_ms(lambda: trainer.learner.sample_actions(
        flat_obs, flat_mask, generator=gen), reps=10)
    env_ms = cuda_ms(lambda: env.step(tstate.env_states, actions), reps=10)
    policy_calls = opcount.count_ops(lambda: trainer.learner.sample_actions(
        flat_obs, flat_mask, generator=gen))[1]
    env_calls = opcount.count_ops(lambda: env.step(tstate.env_states,
                                                   actions))[1]
    phys_calls = opcount.count_ops(lambda: env.physics_step(
        tstate.env_states, ctl))[1]
    print(f"[{label}] per env step: policy sample {policy_ms:.3f} ms, "
          f"env.step {env_ms:.3f} ms of which arena_step {wrapper_ms:.3f} "
          f"ms (kernel {kernel_ms:.3f} ms) (CUDA events); tensor ops "
          f"dispatched: policy sample {policy_calls}, env.step {env_calls} "
          f"(the physics step {phys_calls}, post-physics "
          f"{env_calls - phys_calls})")
    ops = work.ops_needed
    bound_ms, bound_by, bytes_ms, ops_ms = bound(nbytes, ops)
    print(f"[{label}] kernel {kernel_ms:.4f} ms/env step (E={n}, "
          f"C={P}); with pack/unpack {wrapper_ms:.4f} ms; plain version "
          f"{plain_ms:.2f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"({nbytes} bytes -> {bytes_ms:.5f} ms, {ops:.4g} fp32 ops these "
          f"inputs need -> {ops_ms:.5f} ms; the branch-free plain version "
          f"runs {work.ops_branch_free:.4g}); card {card}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "end_err": err}


def check_metrics(label, metrics, before, learner):
    """Every metric finite, the metric keys the JAX trainer's, every
    parameter changed since ``before``."""
    import math
    from reinforcement_learning_torch.learn.ppo import UPDATE_METRICS
    vals = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not math.isfinite(v)]
    if bad:
        fail(f"{label}: metrics not finite: {bad}")
    want = set(UPDATE_METRICS) | {
        "reward_mean", "goal_rate", "touch_rate", "episode_terminals",
        "return_std", "reward_clip_portion", "value_mean"}
    if not want <= set(vals):
        fail(f"{label}: metrics lack {sorted(want - set(vals))}")
    same = [i for i, (p, q) in enumerate(zip(learner.parameters(), before))
            if bool((p == q).all())]
    if same:
        fail(f"{label}: parameters {same} unchanged by the update")
    print(f"[{label}] metrics: " + json.dumps(
        {k: float(f"{v:.4g}") for k, v in vals.items()}))


def train_path(card, gen):
    """The main path: ``Trainer.train_iteration`` at bench.py's shape.  One
    warm-up iteration, 3 timed ones with the kernel's launch count set to
    0 before and read after (24 per iteration), then one iteration split
    into its parts.  Returns the launches of the timed iterations, for
    [deploy] the trained learner with the obs rows and masks of the state
    it ends in, and for [parallel] the warm-up iteration's parameters,
    metrics, return statistic and step count (the first iteration from
    the seed) with the timed iterations' s/iteration."""
    import torch
    from bench_torch import bench_trainer
    trainer = bench_trainer(E, "soccar", SEED)
    if trainer.steps_per_itr != T:
        fail(f"steps_per_itr {trainer.steps_per_itr} != {T}")
    params = trainer.env.params
    if not (params.use_mesh and params.dynamic_wheel_rays):
        fail("the bench trainer's env is not full fidelity")
    before = [p.detach().clone() for p in trainer.learner.parameters()]
    state = trainer.init(SEED)
    t0 = time.perf_counter()
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    first = dp_result(trainer, state, metrics)
    iters = 3
    zero_counters()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter("kernel.launches")
    if launches != iters * T:
        fail(f"train: arena_step launched {launches} times in {iters} "
             f"iterations of {T} env steps")
    check_metrics("train", metrics, before, trainer.learner)
    steps = iters * T * E * CARS
    print(f"[train] bench shape (1024 x 2v2 soccar, full fidelity, batch "
          f"50k, 2 epochs): warm-up {warm:.3f} s; {iters} iterations in "
          f"{wall:.3f} s = {wall / iters:.3f} s/iteration, "
          f"{steps / wall:.0f} player-steps/s; launches {launches} "
          f"({launches // iters} per iteration); card {card}")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t
    (state, traj), t_collect = timed(lambda: trainer.collect(state))
    (state, data, _), t_prep = timed(lambda: trainer.prepare(state, traj))
    _, t_update = timed(lambda: trainer.learner.update(
        data, generator=trainer.generator))
    total = t_collect + t_prep + t_update
    print(f"[train] one iteration split (host clock, synchronised after "
          f"each part): collect {t_collect:.3f} s, values + GAE + Welford "
          f"{t_prep:.3f} s, update {t_update:.3f} s; total {total:.3f} s "
          f"({T * E * CARS / total:.0f} player-steps/s)")
    first["iter_s"] = wall / iters
    return launches, {"learner": trainer.learner,
                      "obs": state.obs.reshape(E * CARS, -1),
                      "masks": state.masks.reshape(E * CARS, -1)}, first


def mode_path(label, mode, card, gen):
    """One ``train_iteration`` of 1024 x 2v2 in a game mode at the bench
    widths, with the launch count set to 0 before and read after; then
    ``end_state`` on the state it ends in.  Returns the mode's ``kernels``
    entry."""
    import torch
    from bench_torch import bench_trainer
    trainer = bench_trainer(E, mode, SEED)
    before = [p.detach().clone() for p in trainer.learner.parameters()]
    state = trainer.init(SEED)
    zero_counters()
    t0 = time.perf_counter()
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter("kernel.launches")
    if launches != T:
        fail(f"{label}: arena_step launched {launches} times in one "
             f"iteration of {T} env steps")
    check_metrics(label, metrics, before, trainer.learner)
    ball = state.env_states.phys.ball
    print(f"[{label}] one train_iteration (1024 x 2v2 {mode}, full "
          f"fidelity): {wall:.3f} s including first use; launches "
          f"{launches}; arenas seeking a goal at the end "
          f"{int((ball.hs_y_target_dir != 0).sum())}, target speed mean "
          f"{float(ball.hs_target_speed.mean()):.1f}")
    actions, _ = trainer.learner.sample_actions(
        state.obs.reshape(E * CARS, -1), state.masks.reshape(E * CARS, -1),
        generator=gen)
    return {"launches": launches,
            **end_state(label, trainer, state, actions.reshape(E, CARS),
                        trainer.env.params, card, gen)}


# ---------------------------------------------------------------------------
# the portable physics engine: soccar, hoops, ball prediction

PORTABLE_SHARE = 0.02   # arenas or balls allowed off, card vs CPU


def _ops_per_step(env, state, actions, r):
    """(tensor ops of one portable tick, of one env.step) dispatched."""
    from reinforcement_learning_torch.ops import opcount
    from reinforcement_learning_torch.physics import step as stepmod
    tick = opcount.count_ops(lambda: stepmod.arena_tick(
        state.phys, env.teams_np, r[:, 0], env.params))[1]
    step = opcount.count_ops(lambda: env.step(state, actions))[1]
    return tick, step


def portable_path(card, gen, played):
    """[portable]: RocketLeagueEnv 1024 x 2v2 soccar with
    physics_backend="portable" from the full-fidelity collection's played
    state: env.step on the card (the kernel's launch count set to 0 before
    and read after: no launch), timed; then the portable ``arena_step`` on
    the card against the same code on the CPU with the same controls and
    per-tick respawn draws, ``compare``'s tolerances, an arena allowed a
    differing flag or a float beyond tolerance in PORTABLE_SHARE of the
    arenas (8 ticks of contacts round differently on the card's libm).
    Returns the worst float deviation over the others."""
    import torch
    from reinforcement_learning_torch.device import tree_map
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.physics import step as stepmod
    dev = torch.device("cuda")
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2,
                                    physics_backend="portable",
                                    device="cuda"))
    if not (env.portable and env.params.use_mesh
            and env.params.dynamic_wheel_rays):
        fail("portable: the env is not the portable route at full fidelity")
    actions = torch.randint(0, env.num_actions, (E, CARS), generator=gen,
                            device=dev)
    controls = env.action_parser.parse(actions)
    r = torch.randint(0, 4, (E, 8, CARS), generator=gen, device=dev,
                      dtype=torch.int32)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = env.step(played, actions)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    step_ms = cuda_ms(lambda: env.step(played, actions), reps=2, warmup=0)
    phys_ms = cuda_ms(lambda: stepmod.arena_step(
        played.phys, controls, env.teams_np, r, env.params), reps=2,
        warmup=0)
    launches = counter("kernel.launches")
    if launches:
        fail(f"portable: the kernel launched {launches} times")
    if not bool(torch.isfinite(out.obs).all()):
        fail("portable: the observations hold NaN or inf")
    ops_tick, ops_step = _ops_per_step(env, played, actions, r)
    got = stepmod.arena_step(played.phys, controls, env.teams_np, r,
                             env.params)
    cpu_phys = tree_map(lambda t: t.cpu(), played.phys)
    t0 = time.perf_counter()
    want = stepmod.arena_step(cpu_phys, controls.cpu(), env.teams_np,
                              r.cpu(), env.params)
    cpu_s = time.perf_counter() - t0
    want = tree_map(lambda t: t.to(dev), want)
    torch.cuda.synchronize()
    print(f"[portable] soccar {E} x 2v2, full fidelity, physics_backend="
          f"'portable': env.step {step_ms:.1f} ms (first {first_s:.2f} s), "
          f"of which the physics (arena_step, 8 ticks) {phys_ms:.1f} ms "
          f"(CUDA events); the same step on the CPU {cpu_s:.2f} s (host "
          f"clock, {torch.get_num_threads()} threads); tensor ops per tick "
          f"{ops_tick}, per env.step {ops_step}; kernel launches 0; "
          f"card {card}")
    return compare("portable", got, want, int(PORTABLE_SHARE * E),
                   sides=("card", "cpu"), floats_count=True)


def hoops_path(card, gen):
    """[hoops]: one ``Trainer.train_iteration`` of 1024 x 2v2 hoops at the
    bench widths (bench_torch.bench_trainer: AdvancedObs 167,
    DefaultAction 90, the 384-wide MLP trio, batch 50k, 2 epochs, 24 env
    steps) through physics_backend "auto", which takes the portable route;
    the kernel's launch count set to 0 before and read after must stay 0.
    Prints the iteration's time split, the player-steps/s, the goals and
    kickoffs, and the ms and tensor ops of an env step."""
    import torch
    from bench_torch import bench_trainer
    trainer = bench_trainer(E, "hoops", SEED)
    env = trainer.env
    if not env.portable or env.config.physics_backend != "auto":
        fail("hoops: the env did not take the portable route by 'auto'")
    if trainer.steps_per_itr != T:
        fail(f"hoops: steps_per_itr {trainer.steps_per_itr} != {T}")
    before = [p.detach().clone() for p in trainer.learner.parameters()]
    state = trainer.init(SEED)
    timers = Timers()
    seen = {}
    collect = trainer.collect

    def keep(*args, **kw):
        out = collect(*args, **kw)
        seen["traj"] = out[1]
        return out
    trainer.collect = keep
    timers.wrap(trainer, "collect", "collect")
    timers.wrap(trainer, "prepare", "values + GAE + Welford")
    timers.wrap(trainer.learner, "update", "update")
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter("kernel.launches")
    del trainer.collect, trainer.prepare, trainer.learner.update
    if launches:
        fail(f"hoops: the kernel launched {launches} times")
    check_metrics("hoops", metrics, before, trainer.learner)
    traj = seen["traj"]
    check_traj("hoops", env, traj, T)
    goals = int(traj["goal"].sum())
    kickoffs = E + int((traj["terminal"] != 0).sum())
    actions = traj["action"][-1]
    r = torch.randint(0, 4, (E, 8, CARS), generator=gen, device="cuda",
                      dtype=torch.int32)
    step_ms = cuda_ms(lambda: env.step(state.env_states, actions), reps=2,
                      warmup=0)
    ops_tick, ops_step = _ops_per_step(env, state.env_states, actions, r)
    split = ", ".join(f"{k} {v:.3f} s" for k, v in timers.s.items())
    print(f"[hoops] one train_iteration ({E} x 2v2 hoops, portable route, "
          f"bench widths, batch 50k, 2 epochs, {T} env steps): {wall:.3f} s "
          f"including first use ({split}); {T * E * CARS / wall:.0f} "
          f"player-steps/s; kernel launches {launches}; goals {goals}, "
          f"kickoffs {kickoffs}; env.step {step_ms:.1f} ms (CUDA events), "
          f"tensor ops per tick {ops_tick}, per env.step {ops_step}; "
          f"card {card}")
    return state.env_states


def ball_pred_path(card, played, mode):
    """[ball_pred]: ``BallPredTracker(120)`` in ``mode`` over the 1024
    balls of a played state, on the card and on the CPU: every entry held
    to ``ops.ctick.TOLERANCES`` (ball pos, vel, ang_vel, rot), a ball
    allowed off in PORTABLE_SHARE of the balls; the ms of an update."""
    import torch
    from reinforcement_learning_torch.device import tree_map
    from reinforcement_learning_torch.ops.ctick import TOLERANCES
    from reinforcement_learning_torch.physics.ball_pred import \
        BallPredTracker
    ball = played.phys.ball
    tracker = BallPredTracker(120, game_mode=mode)
    got = tracker.update(ball)
    ms = cuda_ms(lambda: tracker.update(ball), reps=2, warmup=0)
    t0 = time.perf_counter()
    want = BallPredTracker(120, game_mode=mode).update(
        tree_map(lambda t: t.cpu(), ball))
    cpu_s = time.perf_counter() - t0
    bad = torch.zeros(E, dtype=torch.bool)
    worst = {}
    for k in ("pos", "vel", "ang_vel", "rot"):
        g, w = getattr(got, k).cpu(), getattr(want, k)
        if tuple(g.shape[:2]) != (E, 120) or not bool(
                torch.isfinite(g).all()):
            fail(f"ball_pred: {k} has shape {tuple(g.shape)} or NaN")
        atol, rtol = TOLERANCES[f"arena.ball.{k}"]
        d = (g - w).abs()
        bad |= (d > atol + rtol * w.abs()).reshape(E, -1).any(-1)
        worst[k] = float(d.max())
    n_bad = int(bad.sum())
    good = {k: float((getattr(got, k).cpu() - getattr(want, k)).abs()[~bad]
                     .max()) for k in worst}
    moving = int((ball.vel.norm(dim=-1) > 0).sum())
    print(f"[ball_pred] BallPredTracker(120) in {mode} over {E} balls "
          f"({moving} moving): update "
          f"{ms:.1f} ms on the card (CUDA events), {cpu_s:.2f} s on the CPU; "
          f"balls off the CPU's prediction beyond tolerance {n_bad}; worst "
          f"|card - cpu| over all balls {json.dumps(worst)}, over the "
          f"others {json.dumps(good)}; card {card}")
    if n_bad > int(PORTABLE_SHARE * E):
        fail(f"ball_pred: {n_bad} balls differ card vs CPU (allowed "
             f"{int(PORTABLE_SHARE * E)})")
    falling = (got.vel[:, 1:, 2] < got.vel[:, :-1, 2]).any(-1)
    if not bool(falling.any()):
        fail("ball_pred: no ball fell under gravity")


# ---------------------------------------------------------------------------
# the canonical training program: the train_2v2 and train_1v1 twins

class Timers:
    """Methods wrapped so that each call is timed on the host clock,
    synchronised with the card before and after; seconds summed by
    name."""

    def __init__(self):
        self.s = {}

    def wrap(self, obj, attr, name):
        import torch
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t
            return out
        setattr(obj, attr, timed)


def kernel_at(label, env, phys, actions, card, gen):
    """The kernel against the plain version on ``phys`` stepped with
    ``actions``, the plain run counting the work the inputs need; the
    kernel's and the plain version's times and the bound there.  Returns
    (ms, bound_ms, bound_by, deviation, plain_ms)."""
    import torch
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.ops import ctick, opcount
    params, teams = env.params, tuple(int(t) for t in env.teams_np)
    consts = A._consts(params, teams)
    n, P = phys.cars.boost.shape
    ctl = env.action_parser.parse(actions)
    r = torch.randint(0, 4, (n, P), generator=gen, device=actions.device,
                      dtype=torch.int32)
    work = opcount.step_work(phys, ctl, r, consts)
    got = A.arena_step(phys, ctl, r, params, teams)
    torch.cuda.synchronize()
    err = compare(f"{label}_end_state", got, work.out, 1)
    raw, nbytes = raw_kernel(A._library(), phys, ctl, r, params, teams)
    ms = cuda_ms(raw, reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: ctick.arena_step_reference(phys, ctl, r,
                                                          consts),
                       reps=1, warmup=0)
    bound_ms, bound_by, bytes_ms, ops_ms = bound(nbytes, work.ops_needed)
    print(f"[{label}] kernel {ms:.4f} ms/env step (E={n}, C={P}); plain "
          f"version {plain_ms:.2f} ms; bound {bound_ms:.5f} ms by "
          f"{bound_by} ({nbytes} bytes -> {bytes_ms:.5f} ms, "
          f"{work.ops_needed:.4g} fp32 ops these inputs need -> "
          f"{ops_ms:.5f} ms); card {card}")
    return ms, bound_ms, bound_by, err, plain_ms


def one_step_agrees(label, trainer, state, make_env, sub=32):
    """One env step of the twin's config from the played state's first
    ``sub`` arenas: the kernel on the card against the plain version on
    the CPU, the same actions, respawn draws and kickoff shuffles; obs,
    final obs, reward, every reward component, terminal and masks within
    ``small_collect_agrees``' tolerances."""
    import torch
    from reinforcement_learning_torch import constants as C
    from reinforcement_learning_torch.device import tree_map
    from reinforcement_learning_torch.envs import state_setters
    from reinforcement_learning_torch.ops import arena_step as A
    states = tree_map(lambda t: t[:sub], state.env_states)
    obs, masks = state.obs[:sub], state.masks[:sub]
    P = obs.shape[1]
    actions = trainer.learner.sample_actions(
        obs.reshape(sub * P, -1), masks.reshape(sub * P, -1),
        deterministic=True)[0].reshape(sub, P)
    order = torch.randperm(C.CAR_SPAWN_LOCATION_AMOUNT).repeat(sub, 1)
    r = torch.randint(0, 4, (sub, P), dtype=torch.int32)
    outs = {}
    for where in ("cuda", "cpu"):
        env = make_env(sub, device=where)
        env.state_setter = state_setters.kickoff_state(
            order_fn=lambda n, g, d: order[:n].to(d))
        st = tree_map(lambda t: t.to(where), states)
        ctl = env.action_parser.parse(actions.to(where))
        phys = A.arena_step(st.phys, ctl, r.to(where), env.params,
                            env.teams_np)
        outs[where] = env.post_physics(st, phys, ctl)[1]
    kern, plain = outs["cuda"], outs["cpu"]
    floats = {"obs": (kern.obs, plain.obs),
              "final_obs": (kern.final_obs, plain.final_obs),
              "reward": (kern.reward, plain.reward)}
    floats.update({f"reward/{k}": (v, plain.reward_components[k])
                   for k, v in kern.reward_components.items()})
    worst = {}
    for k, (a, b) in floats.items():
        worst[k] = float((a.cpu() - b).abs().max())
        if worst[k] > 2e-3:
            fail(f"{label}: {k} differs by {worst[k]:.3g} between the "
                 "kernel on the card and the plain version on the CPU "
                 "(tol 2e-3)")
    for k in ("terminal_type", "action_mask", "goal_scored",
              "ball_touched"):
        if not torch.equal(getattr(kern, k).cpu(), getattr(plain, k)):
            fail(f"{label}: {k} differs between the card and the CPU")
    print(f"[{label}] one env step of {sub} played arenas, kernel on the "
          f"card vs plain on the CPU: max |diff| " + json.dumps(
              {k: float(f"{v:.3g}") for k, v in worst.items()})
          + f"; terminals {int((plain.terminal_type > 0).sum())}, "
          f"touches {int(plain.ball_touched.sum())}")


def same_snapshot(label, a, b):
    """Every tensor and number of two checkpoint snapshots equal."""
    import torch
    from reinforcement_learning_torch.utils import checkpoint as ckpt
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    if set(fa) != set(fb):
        fail(f"{label}: the resumed state lacks {sorted(set(fa) ^ set(fb))}")
    n = 0
    for k, v in fa.items():
        w = fb[k]
        if isinstance(v, torch.Tensor):
            same = (v.dtype == w.dtype and v.shape == w.shape
                    and torch.equal(v.cpu(), w.cpu()))
            n += 1
        else:
            same = v == w
        if not same:
            fail(f"{label}: {k} differs after the resume")
    return n


def twin_path(card, gen):
    """[train_2v2]: the canonical training program, built from the twin's
    own ``make_env``, ``auto_scale``, ``ppo_config``, ``trainer_config``
    and ``selfplay_config`` (512 x 2v2, the 13-term reward stack, the
    768-wide model, AdamW, leaky ReLU, self-play with skill matches, user
    metrics, checkpoints), with two deviations, printed: the second timed
    iteration trains against an old version for certain, and skill matches
    run every iteration.  A warm-up and 3 timed iterations with the launch
    count set to 0 before and read after; the self-play checks; the kernel
    against the plain version on the end state at E=512, on the skill
    match's state at E=16 and after one train_1v1 iteration at E=256, C=2;
    one env step on the card against the CPU; a checkpoint saved and
    resumed bit-equal into a fresh trainer, which trains one more
    iteration.  Returns the path's ``kernels`` entry."""
    import dataclasses
    import math
    import shutil

    import torch
    from reinforcement_learning_torch.examples import train_1v1
    from reinforcement_learning_torch.examples import train_2v2 as twin
    from reinforcement_learning_torch.learn import selfplay as sp
    from reinforcement_learning_torch.learn.ppo import \
        _full_fp32_matmul as full_fp32_matmul
    from reinforcement_learning_torch.learn.trainer import Trainer
    from reinforcement_learning_torch.utils import checkpoint as ckpt
    from reinforcement_learning_torch.utils.metrics import MetricSender
    from reinforcement_learning_torch.utils.report import Report
    label = "train_2v2"
    games = twin.NUM_GAMES
    scale = twin.auto_scale(games)
    ppo = twin.ppo_config(scale)
    spc = twin.selfplay_config()
    spc = dataclasses.replace(spc, skill=dataclasses.replace(
        spc.skill, update_interval=1))
    folder = os.path.join(ROOT, "build", "chip_smoke", "train_2v2")
    shutil.rmtree(folder, ignore_errors=True)
    print(f"[{label}] deviations from the example: train_against_old_chance "
          f"1.0 in the second timed iteration (the example: "
          f"{twin.selfplay_config().train_against_old_chance}); skill "
          f"update_interval 1 (the example: "
          f"{twin.selfplay_config().skill.update_interval}); checkpoints "
          f"and metrics under {os.path.relpath(folder, ROOT)}")

    def make_trainer():
        return Trainer(twin.make_env(games), ppo, twin.trainer_config(folder),
                       selfplay=spc, step_metrics_fn=twin.step_metrics)
    trainer = make_trainer()
    env = trainer.env
    counts = trainer.learner.param_counts()
    T2 = trainer.steps_per_itr
    E2, P = env.config.num_envs, env.config.cars_per_arena
    if (scale != 1.5 or counts["total"] != 4_345_435 or T2 != 48
            or ppo.optim != "adamw" or ppo.activation != "leaky_relu"
            or len(env.reward_fns) != 13):
        fail(f"{label}: not the example's configuration: scale {scale}, "
             f"params {counts}, {T2} env steps per iteration")
    print(f"[{label}] scale {scale}: shared {list(ppo.shared_head_layers)}, "
          f"policy {list(ppo.policy_layers)}, critic "
          f"{list(ppo.critic_layers)}, params {counts}; {E2} x 2v2, {T2} "
          f"env steps = {T2 * E2 * P} rows per iteration, batch "
          f"{ppo.batch_size}, {ppo.epochs} epochs, {ppo.optim}, "
          f"{ppo.activation}; rewards "
          f"{[(w.name, w.weight) for w in env.reward_fns]}")

    timers = Timers()
    timers.wrap(trainer, "collect", "collect")
    timers.wrap(trainer, "prepare", "values + GAE + Welford")
    timers.wrap(trainer.learner, "update", "update")
    timers.wrap(trainer.skill_tracker, "run_matches", "skill match")
    seen = {"matches": []}
    tracker = trainer.skill_tracker
    timed_matches = tracker.run_matches

    def checked_matches(learner, bank, rng):
        # the ELO rule for the goals counted, from the ratings before
        before = bank.ratings.clone()
        cur0 = float(sp.current_rating(bank))
        last = (bank.next_slot - 1) % before.shape[0]
        out = timed_matches(learner, bank, rng)
        _, cur, info = out
        idx, c = info["opponent_idx"], cur0
        o = float(before[idx])
        for _ in range(info["new_goals"]):
            c, o = sp.elo_update(c, o, spc.skill.rating_inc)
        for _ in range(info["old_goals"]):
            o, c = sp.elo_update(o, c, spc.skill.rating_inc)
        want = before.clone()
        want[idx] = o
        want[last] = c
        if cur != c or not torch.equal(bank.ratings, want):
            fail(f"{label}: ratings {bank.ratings.tolist()} after "
                 f"{info}, the ELO rule gives {want.tolist()}")
        seen["matches"].append(info)
        return out
    tracker.run_matches = checked_matches
    learn = trainer.learn

    def spy_learn(state, traj, perms=None, weight=None):
        seen["weight"], seen["shape"] = weight, traj["action"].shape
        return learn(state, traj, perms=perms, weight=weight)
    trainer.learn = spy_learn

    # warm-up: snapshots version 0 before its update
    first = [p.detach().clone() for p in trainer.learner.policy.parameters()]
    state = trainer.init_or_resume()
    t0 = time.perf_counter()
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    version = sp.get_version(trainer.bank, 0)["policy"]
    if trainer.bank.count != 1 or not all(
            torch.equal(a, b) for a, b in zip(version.values(), first)):
        fail(f"{label}: version 0 is not the parameters before the update")

    # 3 timed iterations
    before = [p.detach().clone() for p in trainer.learner.parameters()]
    timers.s.clear()
    n_matches = len(seen["matches"])
    zero_counters()
    per_iter = []
    t0 = time.perf_counter()
    for i in range(3):
        trainer.selfplay = dataclasses.replace(
            spc, train_against_old_chance=1.0) if i == 1 else spc
        seen["weight"] = None
        t = time.perf_counter()
        state, metrics = trainer.train_iteration(state)
        torch.cuda.synchronize()
        per_iter.append(time.perf_counter() - t)
        extra = dict(trainer.last_selfplay_metrics)
        if i == 1:
            w = seen["weight"]
            if extra.get("trained_against_old") != 1.0 or w is None:
                fail(f"{label}: the second iteration did not train against "
                     "an old version")
            w = w.reshape(seen["shape"])
            per_player = w[0, 0]
            old = per_player == 0
            teams = env.teams
            if not (torch.equal(w, per_player.expand_as(w))
                    and int(old.sum()) == P // 2
                    and len(set(teams[old].tolist())) == 1):
                fail(f"{label}: old-team weights {per_player.tolist()}")
            print(f"[{label}] iteration {i + 1} trained against an old "
                  f"version: team {int(teams[old][0])}'s rows weight 0, "
                  f"{int((w == 0).sum())} of {w.numel()} rows")
    wall = time.perf_counter() - t0
    launches = counter("kernel.launches")
    matches = len(seen["matches"]) - n_matches
    want = 3 * T2 + matches * tracker.steps_per_run
    if launches != want or matches != 3:
        fail(f"{label}: arena_step launched {launches} times in 3 "
             f"iterations of {T2} env steps and {matches} skill matches of "
             f"{tracker.steps_per_run} (want {want})")
    if all(torch.equal(a, b) for a, b in zip(
            trainer.learner.policy.parameters(), version.values())):
        fail(f"{label}: the bank's version follows the trained parameters")
    logged = {**metrics, **extra}
    missing = [w.name for w in env.reward_fns
               if f"reward/{w.name}" not in logged]
    user = [k for k in logged if k.startswith(("Player/", "Game/"))]
    if missing or len(user) != 8:
        fail(f"{label}: metrics lack the rewards {missing} or user "
             f"metrics (have {user})")
    check_metrics(label, logged, before, trainer.learner)
    Report(logged).display()
    sender = MetricSender(fallback_path=os.path.join(folder,
                                                     "metrics.jsonl"),
                          use_wandb=False)
    sender.send({k: float(v) for k, v in logged.items()},
                step=state.iterations)
    sender.close()
    split = dict(timers.s)
    core = sum(split[k] for k in ("collect", "values + GAE + Welford",
                                  "update"))
    split["self-play host logic"] = wall - core - split["skill match"]
    steps = 3 * T2 * E2 * P
    print(f"[{label}] warm-up {warm:.3f} s; 3 iterations in {wall:.3f} s: "
          + ", ".join(f"{t:.3f}" for t in per_iter) + f" s; "
          f"{steps / wall:.0f} player-steps/s with the skill matches, "
          f"{steps / (wall - split['skill match']):.0f} without; launches "
          f"{launches} ({3 * T2} in the iterations, {matches} skill matches "
          f"x {tracker.steps_per_run}); card {card}")
    print(f"[{label}] split of the 3 iterations (host clock, synchronised "
          f"around each part), s: " + json.dumps(
              {k: round(v, 4) for k, v in split.items()}))
    print(f"[{label}] skill matches: " + json.dumps(seen["matches"])
          + f"; ratings {trainer.bank.ratings[:trainer.bank.count].tolist()}")

    # the kernel on the end state (E=512) and the skill match's (E=16)
    actions = trainer.learner.sample_actions(
        state.obs.reshape(E2 * P, -1), state.masks.reshape(E2 * P, -1),
        generator=gen)[0].reshape(E2, P)
    entry = {"launches": launches,
             **end_state(label, trainer, state, actions, env.params, card,
                         gen)}
    err = entry.pop("end_err")
    sst, sobs, smasks = tracker.env_states
    sa = trainer.learner.sample_actions(
        sobs.reshape(-1, sobs.shape[-1]), smasks.reshape(
            -1, smasks.shape[-1]), generator=gen)[0].reshape(sobs.shape[:2])
    skill = kernel_at("skill_match", tracker.env, sst.phys, sa, card, gen)
    err = max(err, skill[3])
    print(f"[skill_match] E={tracker.env.config.num_envs}: kernel "
          f"{skill[0]:.4f} ms, bound {skill[1]:.5f} ms; launches on this "
          f"path {matches * tracker.steps_per_run}")

    # one env step of this config, the card against the CPU
    one_step_agrees(label, trainer, state, twin.make_env)

    # checkpoint: save, resume into a fresh trainer bit-equal, go on
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = trainer.save(state)
    save_s = time.perf_counter() - t
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    saved = ckpt.snapshot(trainer, state)
    fresh = make_trainer()
    t = time.perf_counter()
    resumed = fresh.init_or_resume()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    n = same_snapshot(label, saved, ckpt.snapshot(fresh, resumed))
    if resumed.total_timesteps != state.total_timesteps:
        fail(f"{label}: resumed at {resumed.total_timesteps} steps")
    # for [deploy]: the saved learner's own fp32 forward on the obs rows of
    # two more env steps
    _, traj = trainer.collect(state, 2)
    rows = traj["obs"].reshape(-1, traj["obs"].shape[-1])
    with torch.no_grad(), full_fp32_matmul():
        own = trainer.learner.policy(trainer.learner.shared_head(rows))
    handoff = {"checkpoint": path, "ppo": ppo, "obs": rows,
               "masks": traj["mask"].reshape(-1, traj["mask"].shape[-1]),
               "logits": own, "params": counts["total"]}
    t = time.perf_counter()
    resumed, m2 = fresh.train_iteration(resumed)
    torch.cuda.synchronize()
    bad = [k for k, v in m2.items() if not math.isfinite(float(v))]
    if bad:
        fail(f"{label}: metrics after the resume not finite: {bad}")
    print(f"[{label}] checkpoint {os.path.relpath(path, ROOT)}: {nbytes} "
          f"bytes, save {save_s:.3f} s, load into a fresh trainer "
          f"{load_s:.3f} s; {n} tensors of the resumed state bit-equal to "
          f"the saved; one more iteration {time.perf_counter() - t:.3f} s "
          f"(iteration {resumed.iterations}); card {card}")
    del fresh, trainer

    # the train_1v1 twin: one iteration, then the kernel on its end state
    tr1 = Trainer(train_1v1.make_env(), train_1v1.ppo_config(),
                  train_1v1.trainer_config())
    e1, p1 = tr1.env.config.num_envs, tr1.env.config.cars_per_arena
    s1 = tr1.init(SEED)
    b1 = [p.detach().clone() for p in tr1.learner.parameters()]
    zero_counters()
    t = time.perf_counter()
    s1, m1 = tr1.train_iteration(s1)
    torch.cuda.synchronize()
    w1 = time.perf_counter() - t
    l1 = counter("kernel.launches")
    if l1 != tr1.steps_per_itr:
        fail(f"train_1v1: arena_step launched {l1} times in one iteration "
             f"of {tr1.steps_per_itr} env steps")
    check_metrics("train_1v1", m1, b1, tr1.learner)
    print(f"[train_1v1] one train_iteration ({e1} x 1v1, "
          f"{tr1.steps_per_itr} env steps, params "
          f"{tr1.learner.param_counts()['total']}): {w1:.3f} s including "
          f"first use, {tr1.steps_per_itr * e1 * p1 / w1:.0f} "
          f"player-steps/s; launches {l1}")
    a1 = tr1.learner.sample_actions(
        s1.obs.reshape(e1 * p1, -1), s1.masks.reshape(e1 * p1, -1),
        generator=gen)[0].reshape(e1, p1)
    one = kernel_at("train_1v1", tr1.env, s1.env_states.phys, a1, card, gen)
    err = max(err, one[3])
    return {**entry, "max_abs_err": err}, handoff


def scripted_2v2(n_ticks):
    """``n_ticks`` game ticks (120 Hz) of a scripted 2v2 as bot-server
    packets: four cars circling on their own halves at different radii
    and rates, each in the air for a second in four with its jump flag
    set, boost draining from different levels to 0 and refilling, the ball
    bouncing across the field and the pads switching in a pattern."""
    import math

    import numpy as np
    packets = []
    for t in range(n_ticks):
        s = t / 120.0
        players = []
        for i in range(4):
            team = i // 2
            r, w = 500.0 + 350.0 * i, 0.7 + 0.3 * i
            ph = w * s + i * math.pi / 2
            air = (t // 120 + i) % 4 == 0
            z = 17.01 + (180.0 * math.sin(math.pi * (t % 120) / 120)
                         if air else 0.0)
            players.append(dict(
                pos=(r * math.cos(ph), r * math.sin(ph)
                     + (2000.0 if team else -2000.0), z),
                yaw=math.remainder(ph + math.pi / 2, 2 * math.pi),
                pitch=0.3 * math.sin(3 * s + i) if air else 0.0,
                roll=0.5 * math.sin(2 * s + i) if air else 0.0,
                vel=(-r * w * math.sin(ph), r * w * math.cos(ph),
                     (180.0 * math.pi * math.cos(math.pi * (t % 120) / 120))
                     if air else 0.0),
                ang_vel=(0.0, 0.0, w), boost=max(0.0, (33.0 * i - 20.0 * s)
                                                 % 110.0 - 10.0),
                team=team, is_on_ground=not air, has_jumped=air))
        bx = 3000.0 * math.sin(0.4 * s)
        bz = 93.15 + abs(600.0 * math.sin(1.3 * s))
        packets.append(dict(
            seconds_elapsed=s, ball_pos=(bx, 4000.0 * math.sin(0.23 * s), bz),
            ball_vel=(1200.0 * math.cos(0.4 * s), 920.0 * math.cos(0.23 * s),
                      780.0 * math.cos(1.3 * s)),
            ball_ang_vel=(1.0, -2.0, 0.5 * math.sin(s)), players=players,
            pads_active=np.array([(t // 90 + k) % 3 != 0 for k in range(34)]),
            pads_timer=np.zeros(34, np.float32)))
    return packets


def packet_players(pkt):
    """A scripted packet's players as ``RLBotAdapter`` takes them."""
    import numpy as np
    from reinforcement_learning_torch.deploy.rlbot_agent import PacketPlayer
    return [PacketPlayer(
        pos=np.asarray(p["pos"], np.float32), yaw=p["yaw"], pitch=p["pitch"],
        roll=p["roll"], vel=np.asarray(p["vel"], np.float32),
        ang_vel=np.asarray(p["ang_vel"], np.float32), boost=p["boost"],
        team=p["team"], is_on_ground=p["is_on_ground"],
        has_jumped=p["has_jumped"]) for p in pkt["players"]]


def host_ms(fn, reps, warmup=3):
    """Mean and largest host-clock time of ``fn`` in ms, each call ending
    in a result on the host (so synchronised with the card)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return sum(times) / reps, max(times)


# the C++ runtime against torch's forward, as tests/test_native_infer.py
# holds the JAX package's: |a - b| <= ATOL + RTOL |b|
LOGIT_RTOL, LOGIT_ATOL = 2e-4, 2e-5
DECISION_MS = 8 / 120 * 1e3    # one decision per 8 ticks at 120 Hz


def top2_margin(logits, masks):
    """The gap between the two largest legal logits of each row."""
    import torch
    top = torch.where(masks, logits, -torch.inf).topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def flips_allowed(label, a, b, logits, masks):
    """Deterministic actions ``a`` and ``b`` may differ only on rows whose
    top-two margin is within twice the logit tolerance; returns the count
    that differ."""
    import torch
    differ = (a.cpu() != b.cpu())
    margin = top2_margin(logits, masks).cpu()
    tol = 2 * (LOGIT_ATOL + LOGIT_RTOL * logits.abs().amax(-1).cpu())
    bad = differ & (margin > tol)
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        fail(f"{label}: {int(bad.sum())} deterministic actions differ where "
             f"the top-two margin allows none (row {i}: margin "
             f"{float(margin[i]):.3g}, tolerance {float(tol[i]):.3g})")
    return int(differ.sum())


def deploy_path(card, bench, twin):
    """[deploy]: the trained policies into a match.  The train_2v2
    checkpoint into ``InferUnit`` on the card (its logits on 4,096 obs rows
    against the trainer's own fp32 forward); the bench-shape ReLU model
    from [train] exported to the C++ runtime and held on the host against
    ``InferUnit`` on the card and the port's CPU forward; a scripted 2v2
    session of 600 ticks through the bot server, through ``RLBotAdapter``
    on the same runtime (equal controls) and through ``RLBotAdapter`` on
    the card's ``InferUnit``; the converter's round trips; the time of a
    decision on the card and on the host."""
    import shutil

    import numpy as np
    import torch
    from reinforcement_learning_torch.deploy import bot_bridge, native
    from reinforcement_learning_torch.deploy.infer import InferUnit
    from reinforcement_learning_torch.deploy.rlbot_agent import RLBotAdapter
    from reinforcement_learning_torch.envs.actions import DefaultAction
    from reinforcement_learning_torch.envs.obs import AdvancedObs
    from reinforcement_learning_torch.tools import checkpoint_converter as cv
    label = "deploy"
    folder = os.path.join(ROOT, "build", "chip_smoke", "deploy")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)

    # the train_2v2 checkpoint (768 wide, leaky ReLU) on the card
    ck = twin["checkpoint"]
    t = time.perf_counter()
    unit2 = InferUnit.from_checkpoint(ck, 2, twin["ppo"])
    load_s = time.perf_counter() - t
    got = unit2.logits(twin["obs"])
    d = float((got - twin["logits"]).abs().max())
    if unit2.learner.param_counts()["total"] != twin["params"] or d > 1e-5:
        fail(f"{label}: the train_2v2 checkpoint's InferUnit "
             f"({unit2.learner.param_counts()['total']} params) differs from "
             f"the trainer's forward by {d:.3g} (tol 1e-5)")
    n_flip = flips_allowed(f"{label} train_2v2", unit2.infer_actions(
        twin["obs"], twin["masks"]), torch.where(
        twin["masks"], twin["logits"], -torch.inf).argmax(-1),
        twin["logits"], twin["masks"])
    print(f"[{label}] train_2v2 checkpoint {os.path.relpath(ck, ROOT)} into "
          f"InferUnit on the card in {load_s:.3f} s "
          f"({twin['params']} params, {twin['ppo'].activation}): logits on "
          f"{len(twin['obs'])} obs rows of a collection vs the trainer's own "
          f"fp32 forward, max |diff| {d:.3g} (tol 1e-5); deterministic "
          f"actions differing from its masked argmax {n_flip}")

    # the bench-shape ReLU model: C++ on the host, InferUnit on the card,
    # torch on the CPU
    learner = bench["learner"]
    obs, masks = bench["obs"], bench["masks"]
    t = time.perf_counter()
    blob = native.export_policy_blob(learner)
    pol = native.NativePolicy(blob)
    build_s = time.perf_counter() - t
    unit = InferUnit.from_params(learner.params_to_jax(), 2,
                                 bench_ppo_config())
    cpu = InferUnit.from_params(learner.params_to_jax(), 2,
                                bench_ppo_config(), device="cpu")
    obs_np, masks_np = obs.cpu().numpy(), masks.cpu().numpy()
    lg_host = torch.from_numpy(pol.logits(obs_np))
    lg_card = unit.logits(obs).cpu()
    lg_cpu = cpu.logits(obs.cpu())
    devs = {}
    for name, a, b in (("C++ vs card", lg_host, lg_card),
                       ("C++ vs torch CPU", lg_host, lg_cpu),
                       ("card vs torch CPU", lg_card, lg_cpu)):
        excess = ((a - b).abs() - LOGIT_RTOL * b.abs()).amax()
        devs[name] = float((a - b).abs().max())
        if float(excess) > LOGIT_ATOL:
            fail(f"{label}: logits {name} beyond rtol {LOGIT_RTOL} atol "
                 f"{LOGIT_ATOL} (max |diff| {devs[name]:.3g})")
    a_host = torch.from_numpy(pol.infer(obs_np, masks_np).astype(np.int64))
    a_card = unit.infer_actions(obs, masks).cpu()
    n_flip = flips_allowed(f"{label} bench", a_host, a_card, lg_card,
                           masks.cpu())
    print(f"[{label}] bench-shape ReLU model from [train] "
          f"({learner.param_counts()['total']} params): blob {len(blob)} "
          f"bytes, export and C++ build/load {build_s:.2f} s; logits on "
          f"{len(obs)} obs rows, max |diff| " + json.dumps(
              {k: float(f"{v:.3g}") for k, v in devs.items()})
          + f" (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}); deterministic "
          f"actions C++ vs card differing {n_flip} of {len(obs)} (each "
          f"within the margin tolerance)")

    # decision latency: InferUnit on the card, the C++ runtime on the host
    lat = {}
    for b in (1, 4):
        o, mk = obs[:b], masks[:b]
        lat[f"InferUnit card b{b}"] = host_ms(
            lambda: unit.infer_actions(o, mk).tolist(), 200)
        lat[f"InferUnit card 768-wide leaky b{b}"] = host_ms(
            lambda: unit2.infer_actions(o, mk).tolist(), 200)
        oh, mh = obs_np[:b], masks_np[:b]
        lat[f"C++ host b{b}"] = host_ms(lambda: pol.infer(oh, mh), 200)

    # a scripted 2v2 session: the server, the adapter on the same runtime,
    # the adapter on the card's InferUnit
    packets = scripted_2v2(600)
    blob_path = os.path.join(folder, "policy.blob")
    with open(blob_path, "wb") as f:
        f.write(blob)
    bots = ((0, 0), (0, 1), (1, 2), (1, 3))
    t = time.perf_counter()
    with bot_bridge.BotServer(blob_path, tick_skip=8, action_delay=7,
                              workdir=folder) as server:
        for team, index in bots:
            bot_bridge.add_bot(server.port, f"bot{index}", team, index)
        client = bot_bridge.PacketClient(server.port)
        try:
            served = [client.send_packet(**p) for p in packets]
        finally:
            client.close()
    server_s = time.perf_counter() - t
    server_ctl = np.stack([[out[i] for _, i in bots] for out in served])

    # the game machine builds the obs on the host; the policy runs in the
    # C++ runtime there or in InferUnit on the card
    host_obs = AdvancedObs(4, unit.obs_builder.teams_np, device="cpu")
    host_parser = DefaultAction(device="cpu")

    def session(make_infer):
        adapters = [RLBotAdapter(make_infer(i), host_obs, host_parser,
                                 tick_skip=8, action_delay=7)
                    for _, i in bots]
        ctl = []
        for p in packets:
            players = packet_players(p)
            ctl.append([a.get_output(p["seconds_elapsed"], p["ball_pos"],
                                     p["ball_vel"], p["ball_ang_vel"],
                                     players, p["pads_active"], i)
                        for a, (_, i) in zip(adapters, bots)])
        return np.stack(ctl).astype(np.float32)

    def native_infer(i):
        return lambda o, m: int(pol.infer(o[None].numpy(),
                                          m[None].numpy())[0])
    host_ctl = session(native_infer)
    if not np.array_equal(host_ctl, server_ctl):
        tick = int(np.nonzero(np.any(host_ctl != server_ctl, (1, 2)))[0][0])
        fail(f"{label}: RLBotAdapter on the C++ runtime and the bot server "
             f"differ first at tick {tick}")
    decisions = {"n": 0, "flips": []}

    def card_infer(i):
        def infer(o, m):
            a = int(unit.infer_actions(o[None], m[None])[0])
            b = int(pol.infer(o[None].numpy(), m[None].numpy())[0])
            if a != b:
                flips_allowed(f"{label} session", torch.tensor([a]),
                              torch.tensor([b]), unit.logits(o[None]).cpu(),
                              m[None])
                decisions["flips"].append((i, decisions["n"]))
            decisions["n"] += 1
            return a
        return infer
    t = time.perf_counter()
    card_ctl = session(card_infer)
    card_s = time.perf_counter() - t
    if not decisions["flips"] and not np.array_equal(card_ctl, server_ctl):
        fail(f"{label}: RLBotAdapter on the card's InferUnit and the bot "
             "server differ with no decision within the margin")
    changes = int(np.any(np.diff(server_ctl, axis=0) != 0, -1).sum())
    distinct = len({tuple(r) for r in server_ctl.reshape(-1, 8).tolist()})
    card_vs_server = ("equal at every tick"
                      if np.array_equal(card_ctl, server_ctl) else
                      "differing after a decision within the margin")
    print(f"[{label}] scripted 2v2 session, {len(packets)} ticks, tick_skip "
          f"8, action_delay 7, 4 bots, the [train] model: bot server "
          f"{server_s:.2f} s; RLBotAdapter (obs on the host) on the C++ "
          f"runtime equal to the server at every tick; on the card's "
          f"InferUnit {card_vs_server}"
          f" ({decisions['n']} decisions, {len(decisions['flips'])} within "
          f"the margin, {card_s:.2f} s); controls changed {changes} times "
          f"over the 4 bots, {distinct} distinct control rows")

    # one get_output call that infers, on the card
    adapter = RLBotAdapter.from_infer_unit(unit, 0)
    p0 = packets[0]
    players0 = packet_players(p0)

    def one_decision():
        adapter.update_action = True
        adapter.get_output(p0["seconds_elapsed"], p0["ball_pos"],
                           p0["ball_vel"], p0["ball_ang_vel"], players0,
                           p0["pads_active"], 0)
    lat["RLBotAdapter.get_output card (infers)"] = host_ms(one_decision, 100)

    # the converter: checkpoint -> .pt -> .npz -> InferUnit, and .lt
    t = time.perf_counter()
    cv.export_to_torch(ck, os.path.join(folder, "pt"))
    cv.import_from_torch(os.path.join(folder, "pt"),
                         os.path.join(folder, "p.npz"))
    via_pt = InferUnit.from_npz(os.path.join(folder, "p.npz"), 2,
                                twin["ppo"]).logits(twin["obs"])
    cv.export_to_lt(ck, os.path.join(folder, "lt"), twin["ppo"].activation)
    cv.import_from_lt(os.path.join(folder, "lt"),
                      os.path.join(folder, "lt.npz"))
    via_lt = InferUnit.from_npz(os.path.join(folder, "lt.npz"), 2,
                                twin["ppo"]).logits(twin["obs"])
    conv_s = time.perf_counter() - t
    if not (torch.equal(via_pt, got) and torch.equal(via_lt, got)):
        fail(f"{label}: the converter's round trips changed the logits")
    print(f"[{label}] converter: checkpoint -> .pt -> .npz -> InferUnit "
          f"and checkpoint -> .lt -> .npz -> InferUnit, logits bit-equal to "
          f"the checkpoint's on {len(twin['obs'])} rows ({conv_s:.2f} s)")
    print(f"[{label}] decision latency, ms (mean, max; host clock, the "
          f"result on the host; budget {DECISION_MS:.1f} ms per decision at "
          f"tick_skip 8): " + json.dumps(
              {k: [round(v[0], 4), round(v[1], 4)] for k, v in lat.items()})
          + f"; card {card}")


# the card against the CPU for the geometry queries: float32 on both, the
# reductions and products rounding apart in the last bits.  At arena scale
# (coordinates up to 8192 uu, where float32's spacing is 4.9e-4 uu) a
# contact point comes out of a chain of about 8 such roundings, so lengths
# agree to 8 spacings; in bt units (1/50) the box-box chain to 1e-4.  A
# flag may differ in at most THRESHOLD_SHARE of the rows, and only where
# its deciding length is within GEOM_ATOL of the threshold.
GEOM_ATOL = 4e-3     # uu
BB_ATOL = 1e-4       # bt (5e-3 uu), box-box points and depths


def close_where(label, what, got, want, atol, rows=None):
    """max |got - want| over ``rows`` (all by default); fails beyond
    ``atol``."""
    d = (got.cpu() - want).abs()
    if rows is not None:
        d = d[rows]
    d = float(d.max()) if d.numel() else 0.0
    if d > atol:
        fail(f"{label}: {what} card vs CPU differ by {d:.3g} (tol {atol})")
    return d


def flags_agree(label, what, got, want, margin=None):
    """Flags equal in all but THRESHOLD_SHARE of the rows (a row: the
    leading index), and, given ``margin``, only where |margin| <=
    GEOM_ATOL.  Returns the flags both set and the count of differing
    entries."""
    import torch
    got = got.cpu()
    differ = got != want
    bad = (differ & (margin.cpu().abs() > GEOM_ATOL) if margin is not None
           else torch.zeros_like(differ))
    rows = differ.reshape(len(differ), -1).any(-1)
    if bool(bad.any()) or int(rows.sum()) > THRESHOLD_SHARE * len(rows) + 1:
        fail(f"{label}: {what} flags differ card vs CPU in "
             f"{int(rows.sum())} rows, {int(bad.sum())} beyond the margin")
    return got & want, int(differ.sum())


def geometry_path(card, gen, positions):
    """[geometry]: the procedural soccar and hoops MeshGrids baked onto the
    card through ``world.get_grid``; ``sphere_contacts`` for 1,024 balls,
    ``raycast`` for 1,024 x 4 x 4 wheel rays and ``box_contacts`` for 4,096
    car hitboxes, drawn from every state [full]'s warm-up collection
    stepped from; ``box_box_manifold`` on 4,096 overlapping car pairs; each
    on the card against the CPU, and timed at that batch."""
    import numpy as np
    import torch
    from reinforcement_learning_torch import constants as C
    from reinforcement_learning_torch import maths as m
    from reinforcement_learning_torch.physics import box_box, world
    from reinforcement_learning_torch.physics.formulas import \
        box_effective_half_extents_bt
    from reinforcement_learning_torch.physics.state import CarConfig
    label = "geometry"
    dev = torch.device("cuda")
    grids = {}
    for mode in ("soccar", "hoops"):
        world.init()
        t = time.perf_counter()
        grid = world.get_grid(mode)
        torch.cuda.synchronize()
        bake_s = time.perf_counter() - t
        if (grid.tri_a.device.type != "cuda"
                or world.get_grid(mode) is not grid):
            fail(f"{label}: get_grid({mode!r}) is not on the card or not "
                 "kept")
        grids[mode] = (grid, grid.to("cpu"))
        print(f"[{label}] {mode} MeshGrid baked and moved to the card in "
              f"{bake_s:.2f} s: {grid.tri_a.shape[0]} triangles, cells "
              f"{list(grid.cells.shape)}")

    ball_pos, car_pos, car_rot = positions
    pick = torch.Generator(device=dev).manual_seed(SEED)
    balls = ball_pos[torch.randperm(len(ball_pos), generator=pick,
                                    device=dev)[:E]]
    ci = torch.randperm(len(car_pos) * CARS, generator=pick,
                        device=dev)[:E * CARS]
    cpos = car_pos.reshape(-1, 3)[ci]
    crot = car_rot.reshape(-1, 3, 3)[ci]
    cfg = CarConfig()
    he = torch.tensor(cfg.hitbox_size, device=dev) / 2
    hit_c = cpos + m.rotate(crot, torch.tensor(cfg.hitbox_offset,
                                               device=dev))
    starts = cpos[:, None] + torch.einsum(
        'nij,wj->nwi', crot, torch.tensor(cfg.wheel_offsets(), device=dev))
    dirs = -crot[:, None, :, 2].expand_as(starts)
    # the wheel ray's length as the portable engine casts it (JAX
    # physics/car.py:152-157): rest + travel + radius - the subtraction
    ray_len = torch.tensor(
        cfg.sus_rest_lengths() + cfg.wheel_radii()
        + C.BTVehicle.MAX_SUSPENSION_TRAVEL
        - C.BTVehicle.SUSPENSION_SUBTRACTION * C.BT_TO_UU, device=dev)
    ray_len = ray_len.expand(starts.shape[:-1])
    print(f"[{label}] queries from {len(ball_pos)} ball and "
          f"{len(car_pos) * CARS} car positions of the states [full]'s "
          f"warm-up collection stepped from: ball z "
          f"{float(balls[:, 2].min()):.1f}..{float(balls[:, 2].max()):.1f}, "
          f"car z {float(cpos[:, 2].min()):.1f}.."
          f"{float(cpos[:, 2].max()):.1f}")

    grid, cpu = grids["soccar"]
    r = C.BALL_COLLISION_RADIUS_SOCCAR
    out = {}

    # every candidate's depth, point and normal is compared, live or not
    n, d, a = grid.sphere_contacts(balls, r)
    nc, dc, ac = cpu.sphere_contacts(balls.cpu(), r)
    both, nflip = flags_agree(label, "sphere", a, ac, d)
    out["sphere_contacts"] = dict(
        batch=f"{len(balls)} balls x {d.shape[-1]} candidates",
        live=int(both.sum()), flags_differing=nflip,
        depth=close_where(label, "sphere depth", d, dc, GEOM_ATOL),
        normal_x_dist=close_where(label, "sphere normal x distance",
                                  n * (r - d)[..., None],
                                  nc * (r - dc)[..., None], GEOM_ATOL),
        ms=cuda_ms(lambda: grid.sphere_contacts(balls, r), 20))

    # every candidate, and the 12 the portable engine keeps by AABB
    # overlap (JAX contacts.py MESH_COMPACT_K_RAY, car.py:166-169)
    for name, kc in (("raycast", None), ("raycast k_compact=12", 12)):
        hit, rd, rn = grid.raycast(starts, dirs, ray_len, k_compact=kc)
        hc, rdc, rnc = cpu.raycast(starts.cpu(), dirs.cpu(), ray_len.cpu(),
                                   k_compact=kc)
        both, nflip = flags_agree(label, name, hit, hc,
                                  rdc - ray_len.cpu())
        out[name] = dict(
            batch=f"{hit.numel()} wheel rays", hits=int(both.sum()),
            flags_differing=nflip,
            dist=close_where(label, f"{name} distance", rd, rdc, GEOM_ATOL),
            normal=close_where(label, f"{name} normal", rn, rnc, GEOM_ATOL,
                               both),
            ms=cuda_ms(lambda: grid.raycast(starts, dirs, ray_len,
                                            k_compact=kc), 20))

    hev = he.expand(hit_c.shape)
    bn, bp, bd, ba = grid.box_contacts(hit_c, crot, hev)
    bnc, bpc, bdc, bac = cpu.box_contacts(hit_c.cpu(), crot.cpu(),
                                          hev.cpu())
    # a box contact is live where it is deep enough and its support point
    # projects into the triangle: no one length decides it
    both, nflip = flags_agree(label, "box", ba, bac)
    out["box_contacts"] = dict(
        batch=f"{len(hit_c)} car hitboxes x {bd.shape[-1]} candidates",
        live=int(both.sum()), flags_differing=nflip,
        depth=close_where(label, "box depth", bd, bdc, GEOM_ATOL),
        point=close_where(label, "box point", bp, bpc, GEOM_ATOL),
        normal=close_where(label, "box normal", bn, bnc, 1e-5),
        ms=cuda_ms(lambda: grid.box_contacts(hit_c, crot, hev), 20))

    # 4,096 car pairs set to overlap, in bt units as the tick runs them
    he_bt = torch.tensor(box_effective_half_extents_bt(cfg.hitbox_size),
                         dtype=torch.float32, device=dev)
    p1 = hit_c / C.BT_TO_UU
    off = (torch.rand(len(p1), 3, generator=gen, device=dev) * 2 - 1) \
        * 1.8 * he_bt
    p2 = p1 + m.rotate(crot, off)
    q, rr = torch.linalg.qr(torch.randn(len(p1), 3, 3, generator=gen,
                                        device=dev))
    q = q * torch.sign(torch.diagonal(rr, dim1=-2, dim2=-1))[:, None, :]
    q[torch.linalg.det(q) < 0, :, 0] *= -1
    R2 = q
    args = (p1, crot, he_bt, p2, R2, he_bt)
    mf = box_box.box_box_manifold(*args)
    mfc = box_box.box_box_manifold(*(x.cpu() for x in args))
    same = (mf["code"].cpu() == mfc["code"]) & (
        mf["active"].cpu() == mfc["active"]).all(-1)
    if int((~same).sum()) > THRESHOLD_SHARE * len(same) + 1:
        fail(f"{label}: box_box_manifold codes or slots differ card vs CPU "
             f"in {int((~same).sum())} of {len(same)} pairs")
    act = mf["active"].cpu() & same[:, None]
    out["box_box_manifold"] = dict(
        batch=f"{len(p1)} car pairs (bt units)",
        overlapping=int(mf["overlap"].sum()),
        edge_codes=int((mf["code"] > 6).sum()),
        pairs_differing=int((~same).sum()),
        depth=close_where(label, "box-box depth", mf["depth"], mfc["depth"],
                          BB_ATOL, act),
        point=close_where(label, "box-box point", mf["points"],
                          mfc["points"], BB_ATOL, act),
        normal=close_where(label, "box-box normal", mf["normal"],
                           mfc["normal"], BB_ATOL, same),
        ms=cuda_ms(lambda: box_box.box_box_manifold(*args), 20))
    if out["box_box_manifold"]["overlapping"] < len(p1) // 2:
        fail(f"{label}: only {out['box_box_manifold']['overlapping']} of "
             f"{len(p1)} car pairs overlap")

    hgrid, hcpu = grids["hoops"]
    hb = balls * torch.tensor([C.ARENA_EXTENT_X_HOOPS / C.ARENA_EXTENT_X,
                               C.ARENA_EXTENT_Y_HOOPS / C.ARENA_EXTENT_Y,
                               1.0], device=dev)
    hr = C.BALL_COLLISION_RADIUS_HOOPS
    n, d, a = hgrid.sphere_contacts(hb, hr)
    nc, dc, ac = hcpu.sphere_contacts(hb.cpu(), hr)
    both, nflip = flags_agree(label, "hoops sphere", a, ac, d)
    out["hoops sphere_contacts"] = dict(
        batch=f"{len(hb)} balls scaled into the hoops arena",
        live=int(both.sum()), flags_differing=nflip,
        depth=close_where(label, "hoops sphere depth", d, dc, GEOM_ATOL),
        ms=cuda_ms(lambda: hgrid.sphere_contacts(hb, hr), 20))
    for name, v in out.items():
        print(f"[{label}] {name}: " + json.dumps(
            {k: (float(f"{x:.4g}") if isinstance(x, float) else x)
             for k, x in v.items()}))
    print(f"[{label}] tolerances card vs CPU: lengths {GEOM_ATOL} uu over "
          f"every candidate (live or not), box-box {BB_ATOL} bt, flags only "
          f"where within the length tolerance of the threshold; times are "
          f"CUDA-event means of 20 calls; card {card}")


# ---------------------------------------------------------------------------
# data parallelism: parallel/mesh.py

DP_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_sharding.py's
DP_REWARD_ATOL = 1e-4
# the iteration's metrics and return statistic, as test_torch_parallel.py
# holds them: a wrong denominator or a doubled all-reduce scales the
# gradient, which the global-norm clip and Adam leave out of the
# parameters, but not out of the losses
DP_METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
DP_TIMEOUT = 300.0   # s, a job of ranks, from their start


def dp_result(trainer, state, metrics) -> dict:
    """What [parallel] holds against the unsharded run after one
    iteration: the parameters, every metric, the return statistic and the
    step count."""
    st = state.return_stat
    return {"params": {k: v.detach().cpu().clone() for k, v in
                       trainer.learner.state_dict().items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "reward_mean": float(metrics["reward_mean"]),
            "return_stat": [float(st.count), float(st.mean), float(st.m2)],
            "total_timesteps": state.total_timesteps}


def dp_rank(rank, world, backend, folder, card):
    """One rank of the data-parallel main path, in a spawned process:
    ``initialize_distributed`` -> ``make_mesh`` -> ``shard_train_state``
    -> ``Trainer.train_iteration`` at bench shape on its E/W arenas, the
    kernel's launch count set to 0 before and read after.  A second
    iteration is timed; then the cost of the reset draw at the global
    width against one at the block's, the kernel on the rank's end state
    (the ranks in turn), and on rank 0 of two the kernel against the plain
    version there.  Writes its results to ``folder/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from bench_torch import bench_trainer
    from reinforcement_learning_torch.envs.shard import EnvShard
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.parallel import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M.initialize_distributed(f"file://{folder}/store", world, rank,
                             device="cuda", backend=backend)
    mesh = M.make_mesh(world, device_type="cuda")
    trainer = bench_trainer(E, "soccar", SEED)
    state = M.shard_train_state(trainer, trainer.init(SEED), mesh)
    env, shard = trainer.env, trainer.env.shard
    n = shard.local_envs

    def timed_iteration():
        nonlocal state
        zero_counters()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_iteration(state)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0
    metrics, first_s = timed_iteration()
    res = {"launches": counter("kernel.launches"),
           **dp_result(trainer, state, metrics), "first_s": first_s,
           "bytes": counter("shard.all_sum.bytes"),
           "reductions": counter("shard.all_sum.calls")}
    _, res["iter_s"] = timed_iteration()

    # the reset draw at the global width (kept block) vs the block's width
    res["reset_ms"] = cuda_ms(env._reset_states, reps=5)
    env.shard = EnvShard(n)
    res["reset_block_ms"] = cuda_ms(env._reset_states, reps=5)
    env.shard = shard

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1 + rank)
    actions, _ = trainer.learner.sample_actions(
        state.obs.reshape(n * CARS, -1), state.masks.reshape(n * CARS, -1),
        generator=gen)
    actions = actions.reshape(n, CARS)
    params = env.params
    teams = tuple(int(t) for t in env.teams_np)
    raw, _ = raw_kernel(A._library(), state.env_states.phys,
                        env.action_parser.parse(actions),
                        torch.randint(0, 4, (n, CARS), generator=gen,
                                      device="cuda", dtype=torch.int32),
                        params, teams)
    for r in range(world):
        dist.barrier()
        if r == rank:
            res["kernel_ms"] = cuda_ms(raw, reps=10, warmup=2)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0 and world > 1:
        res["entry"] = end_state("parallel", trainer, state, actions, params,
                                 card, gen)
    torch.save(res, os.path.join(folder, f"rank{rank}.pt"))


def run_ranks(world, backend, card):
    """Spawn ``world`` ranks of ``dp_rank`` (CUDA cannot fork), join them
    within ``DP_TIMEOUT``; fails if one hangs or fails.  Returns their
    results."""
    import multiprocessing as mp
    import shutil
    import tempfile
    import torch
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    folder = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dp_rank,
                             args=(r, world, backend, folder, card))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        if hung:
            fail(f"[parallel] {world} {backend} ranks: ranks {hung} still "
                 f"ran after {DP_TIMEOUT:.0f} s and were killed")
        codes = [p.exitcode for p in procs]
        if any(codes):
            fail(f"[parallel] {world} {backend} ranks: exit codes {codes}")
        return [torch.load(os.path.join(folder, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def dp_agrees(label, res, first):
    """Every parameter of a rank against the unsharded run's at the JAX
    sharding test's tolerance, reward_mean within 1e-4, every metric
    (the update's losses, KL, entropy, clip fraction, value_mean, ...)
    and the return statistic at ``DP_METRIC_TOL``, the step count exact;
    prints the max deviation of every parameter and metric.  Returns the
    largest parameter deviation."""
    dev = {k: float((res["params"][k] - w).abs().max())
           for k, w in first["params"].items()}
    bad = [k for k, w in first["params"].items()
           if not bool(((res["params"][k] - w).abs()
                        <= DP_TOL["atol"] + DP_TOL["rtol"] * w.abs()).all())]
    d_reward = abs(res["reward_mean"] - first["reward_mean"])
    print(f"[parallel] {label}: max |param - unsharded| per parameter: "
          + json.dumps({k: float(f"{v:.3g}") for k, v in dev.items()}))
    print(f"[parallel] {label}: reward_mean {res['reward_mean']:.6f} vs "
          f"{first['reward_mean']:.6f} unsharded (|diff| {d_reward:.3g})")
    if bad:
        worst = max(bad, key=lambda k: dev[k])
        fail(f"[parallel] {label}: {len(bad)} parameters beyond rtol "
             f"{DP_TOL['rtol']}, atol {DP_TOL['atol']} of the unsharded "
             f"run: {bad}; the largest deviation {dev[worst]:.3g} on "
             f"{worst}")
    if d_reward >= DP_REWARD_ATOL:
        fail(f"[parallel] {label}: reward_mean differs by {d_reward:.3g}")
    if set(res["metrics"]) != set(first["metrics"]):
        fail(f"[parallel] {label}: metrics {sorted(res['metrics'])} != "
             f"{sorted(first['metrics'])}")
    pairs = {**{k: (res["metrics"][k], v)
                for k, v in first["metrics"].items()},
             **{f"return_stat.{k}": (a, b) for k, a, b in zip(
                 ("count", "mean", "m2"), res["return_stat"],
                 first["return_stat"])}}
    d_metric = {k: abs(a - b) for k, (a, b) in pairs.items()}
    print(f"[parallel] {label}: |metric - unsharded|: " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in d_metric.items()}))
    off = {k: (a, b) for k, (a, b) in pairs.items()
           if not abs(a - b) <= (DP_METRIC_TOL["atol"]
                                 + DP_METRIC_TOL["rtol"] * abs(b))}
    if off:
        fail(f"[parallel] {label}: beyond rtol {DP_METRIC_TOL['rtol']}, "
             f"atol {DP_METRIC_TOL['atol']} of the unsharded run "
             f"(sharded, unsharded): {off}")
    if res["total_timesteps"] != first["total_timesteps"]:
        fail(f"[parallel] {label}: total_timesteps {res['total_timesteps']}"
             f" != {first['total_timesteps']} unsharded")
    return max(dev.values())


def parallel_path(card, first):
    """[parallel]: the main path through ``parallel/mesh.py`` against the
    unsharded run from the same seed (``first``, [train]'s warm-up
    iteration): (a) one NCCL rank holding all 1024 arenas; (b) two gloo
    ranks sharing the card (NCCL refuses two ranks on one card), 512
    arenas each, bit-equal to each other.  Returns (b)'s ``kernels``
    entry: rank 0's kernel on its end state against the plain version."""
    import torch
    (a,) = run_ranks(1, "nccl", card)
    if a["launches"] != T:
        fail(f"[parallel] (a): arena_step launched {a['launches']} times "
             f"in one iteration of {T} env steps")
    dp_agrees(f"(a) 1 NCCL rank, E={E}", a, first)
    print(f"[parallel] (a) 1 NCCL rank x {E} arenas: first iteration "
          f"{a['first_s']:.3f} s, then {a['iter_s']:.3f} s/iteration; "
          f"unsharded {first['iter_s']:.3f} s/iteration ([train]'s timed "
          f"iterations); {a['bytes']} bytes all-reduced per iteration in "
          f"{a['reductions']} all-reduces; reset draw {a['reset_ms']:.3f} "
          f"ms (launches {a['launches']}); card {card}")

    ranks = run_ranks(2, "gloo", card)
    for r, res in enumerate(ranks):
        if res["launches"] != T:
            fail(f"[parallel] (b) rank {r}: arena_step launched "
                 f"{res['launches']} times in one iteration of {T} env "
                 "steps")
        dp_agrees(f"(b) 2 gloo ranks, E={E // 2}, rank {r}", res, first)
    same = [k for k in ranks[0]["params"]
            if not torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])]
    if same:
        fail(f"[parallel] (b): the ranks' parameters differ: {same}")
    for r, res in enumerate(ranks):
        print(f"[parallel] (b) rank {r} of 2 (gloo, sharing the card), "
              f"{E // 2} arenas: first iteration {res['first_s']:.3f} s, "
              f"then {res['iter_s']:.3f} s/iteration (unsharded {E} arenas: "
              f"{first['iter_s']:.3f} s; two ranks on one card measure "
              f"contention, not scaling); {res['bytes']} bytes all-reduced "
              f"per iteration in {res['reductions']} all-reduces; kernel "
              f"{res['kernel_ms']:.4f} ms/env step at E={E // 2} (ranks in "
              f"turn); reset draw at the global width {res['reset_ms']:.3f} "
              f"ms, at the block's {res['reset_block_ms']:.3f} ms; "
              f"launches {res['launches']}; card {card}")
    print("[parallel] (b) the two ranks' parameters are bit-equal")
    entry = ranks[0]["entry"]
    return {"launches": ranks[0]["launches"], "ms": ranks[0]["kernel_ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "max_abs_err": entry["end_err"]}


# ---------------------------------------------------------------------------
# the parity instruments and the profilers: tools/ twins

PARITY_T = 240
# BallState::Matches (Ball.h:38): pos 0.8 uu, vel 0.4 uu/s, ang_vel 0.02
MARGINS = dict(car_pos=0.8, car_vel=0.4, car_ang=0.02, ball_pos=0.8,
               ball_vel=0.4)
# PARITY.md's rows that are exact on both JAX engines: gated on both routes
EXACT_ROWS = ("drive_forward", "drive_reverse", "steer_circle", "powerslide",
              "boost_ground", "jump_short", "jump_held", "double_jump",
              "ball_drop", "car_bump")
# PARITY.md's battery table (the JAX engines, 240 ticks): xla pos, vel,
# ang, kernel pos, vel; car columns, or ball columns (ang None)
PARITY_MD = {
    "drive_forward": (0.00, 0.00, 0.000, 0.00, 0.00),
    "drive_reverse": (0.00, 0.00, 0.000, 0.00, 0.00),
    "steer_circle": (0.00, 0.00, 0.000, 0.00, 0.00),
    "powerslide": (0.00, 0.00, 0.000, 0.00, 0.00),
    "boost_ground": (0.00, 0.00, 0.000, 0.00, 0.00),
    "jump_short": (0.00, 0.00, 0.000, 0.00, 0.00),
    "jump_held": (0.00, 0.00, 0.000, 0.00, 0.00),
    "double_jump": (0.00, 0.01, 0.000, 0.00, 0.01),
    "front_flip": (2.93, 11.38, 0.546, 2.52, 9.89),
    "air_pitch": (0.45, 4.83, 0.197, 0.45, 4.82),
    "air_yaw": (0.29, 5.62, 0.106, 0.29, 5.62),
    "air_roll": (0.48, 10.12, 0.457, 1.01, 10.12),
    "air_boost": (0.27, 3.91, 0.068, 0.27, 3.91),
    "air_drift": (0.29, 5.56, 0.125, 0.29, 5.56),
    "ball_drop": (0.00, 0.00, None, 0.00, 0.00),
    "ball_bounce_spin": (0.19, 0.25, None, 0.19, 0.25),
    "ball_roll": (0.07, 0.08, None, 0.07, 0.08),
    "ball_wall": (0.24, 0.18, None, 0.24, 0.18),
    "car_ball_hit": (0.85, 0.64, None, 8.92, 838.7),
    "ball_ramp_wall": (0.36, 0.38, None, 21.9, 107.0),
    "ball_corner": (24.18, 114.3, None, 10.0, 111.9),
    "ball_goal_mouth": (1.14, 0.22, None, 1.14, 0.22),
    "car_wall_ride": (0.07, 0.12, 0.016, 15.2, 11.7),
    "car_on_ball": (5.74, 10.31, 0.108, 22.2, 14.8),
    "car_bump": (0.00, 0.00, 0.000, 0.01, 0.06),
    "car_demo": (144.5, 1222.0, 7.83, 15.8, 168.5),
}
# battery ticks at which the kernel is held against its plain version
PARITY_CHECK_TICKS = (0, 60, 120, 180, 239)


def battery_kernel(card, label, scs, ts):
    """The kernel's launch shape of the battery (tick_skip 1, action delay
    0): the scenarios ``scs`` of one signature as one arena axis, stepped
    by the kernel through ``PARITY_T`` ticks; at ``PARITY_CHECK_TICKS`` the
    kernel is held against the plain version on the same state and
    controls to ``ops.ctick.DEFAULT_TOLERANCE`` with no flag differing.
    At tick ``ts`` the plain run counts the work the inputs need (the
    bound) and the kernel alone and the plain version are timed.  Returns
    ms, plain_ms, bound_ms, bound_by and the deviation."""
    import numpy as np
    import torch
    from reinforcement_learning_torch.device import tree_map
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.ops import ctick, opcount
    from reinforcement_learning_torch.ops.ctick import DEFAULT_TOLERANCE
    from reinforcement_learning_torch.physics.step import ArenaParams
    from reinforcement_learning_torch.tools import parity
    dev = torch.device("cuda")
    n_cars = scs[0].n_cars
    teams = tuple(c.team for c in scs[0].cars)
    params = ArenaParams(num_cars=n_cars, use_mesh=True,
                         dynamic_wheel_rays=True)
    consts = A._consts(params, teams)
    phys = tree_map(lambda *xs: torch.stack(xs),
                    *[parity._scenario_phys(sc, params, dev) for sc in scs])
    E = len(scs)
    r = torch.zeros((E, n_cars), dtype=torch.int32, device=dev)
    ctl_all = torch.as_tensor(np.stack([sc.controls for sc in scs], 1),
                              device=dev)
    err, out = 0.0, {}
    for t in range(PARITY_T):
        got = A.arena_step(phys, ctl_all[t], r, params, teams, 1, 0)
        if t in PARITY_CHECK_TICKS:
            if t == ts:
                work = opcount.step_work(phys, ctl_all[t], r, consts, 1, 0)
                want = work.out
            else:
                want = ctick.arena_step_reference(phys, ctl_all[t], r,
                                                  consts, 1, 0)
            torch.cuda.synchronize()
            err = max(err, compare(f"{label}_t{t}", got, want, 0,
                                   tolerance=DEFAULT_TOLERANCE))
            if t == ts:
                raw, nbytes = raw_kernel(A._library(), phys, ctl_all[t], r,
                                         params, teams, 1, 0)
                out["ms"] = cuda_ms(raw, reps=20, warmup=2)
                out["plain_ms"] = cuda_ms(
                    lambda: ctick.arena_step_reference(
                        phys, ctl_all[t], r, consts, 1, 0), reps=1,
                    warmup=0)
                bound_ms, bound_by, bytes_ms, ops_ms = bound(
                    nbytes, work.ops_needed)
                out.update(bound_ms=bound_ms, bound_by=bound_by)
                print(f"[{label}] kernel {out['ms']:.4f} ms/tick (E={E}, "
                      f"C={n_cars}, tick_skip 1, at tick {t}); plain "
                      f"version {out['plain_ms']:.2f} ms; bound "
                      f"{bound_ms:.6f} ms by {bound_by} ({nbytes} bytes -> "
                      f"{bytes_ms:.6f} ms, {work.ops_needed:.4g} fp32 ops "
                      f"these inputs need -> {ops_ms:.6f} ms); card {card}")
        phys = got
    print(f"[{label}] kernel vs plain at ticks {list(PARITY_CHECK_TICKS)} of "
          f"the battery: worst deviation {err:.3g} (tolerance "
          f"{DEFAULT_TOLERANCE}, no flag differing)")
    out["max_abs_err"] = err
    return out


def parity_row(route, name, e):
    """One battery row beside PARITY.md's JAX figures."""
    xp, xv, xa, kp, kv = PARITY_MD[name]
    ball = xa is None
    jax_route = "kernel" if route == "kernel" else "xla"
    ref = (f"{kp:.2f} / {kv:.2f}" if route == "kernel" else
           f"{xp:.2f} / {xv:.2f}" + ("" if ball else f" / {xa:.3f}"))
    cols = ("ball pos / vel" if ball else
            "car pos / vel" + ("" if route == "kernel" else " / ang"))
    gate = "gated" if name in EXACT_ROWS else "printed"
    print(f"[parity] {route:8s} {name:16s} car {e['car_pos']:8.3f} "
          f"{e['car_vel']:8.3f} {e['car_ang']:7.4f} ball "
          f"{e['ball_pos']:8.3f} {e['ball_vel']:8.3f} flags "
          f"{','.join(e['flags']) or '-'}; PARITY.md JAX {jax_route} "
          f"{cols}: {ref} ({gate})")


def parity_path(card):
    """The parity instruments on the card: the 26-scenario battery through
    the reference oracle on the host, the kernel route (T=240) and the
    portable engine, with the gate on PARITY.md's exact rows; the kernel
    at the battery's launch shape against its plain version; one
    teacher-forced run through the kernel.  Returns the two battery
    groups' ``kernels`` entries."""
    import torch
    from reinforcement_learning_torch.tools import (parity, parity_battery,
                                                    parity_teacher)
    import concurrent.futures
    scs = parity_battery.scenarios(PARITY_T)
    names = list(scs)

    def oracle():
        # a process of its own on the host, beside the card's work
        t0 = time.perf_counter()
        refs = parity.run_oracle([scs[n] for n in names])
        return dict(zip(names, refs)), time.perf_counter() - t0
    pool = concurrent.futures.ThreadPoolExecutor(1)
    oracle_run = pool.submit(oracle)
    groups = {}
    for n in names:
        groups.setdefault(scs[n].n_cars, []).append(n)
    if sorted(groups) != [1, 2] or len(groups[2]) != 2:
        fail(f"the battery's groups changed: {groups}")

    # the kernel route: each group through parity.run_torch_kernel, the
    # launch count set to 0 before and read after
    traces, entries = {}, {}
    for n_cars, group in sorted(groups.items()):
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        out = parity.run_torch_kernel([scs[n] for n in group])
        wall = time.perf_counter() - t0
        launches = counter("kernel.launches")
        if launches != PARITY_T:
            fail(f"parity: the kernel launched {launches} times in "
                 f"{PARITY_T} ticks of the {n_cars}-car group")
        traces.update(zip(group, out))
        print(f"[parity] kernel route, {len(group)} scenarios x {n_cars} "
              f"car(s) as one arena axis: {PARITY_T} ticks in {wall:.2f} s, "
              f"launches {launches}; card {card}")
        entries[n_cars] = {"launches": launches}
    for n_cars, group in sorted(groups.items()):
        entries[n_cars].update(battery_kernel(
            card, f"parity_kernel_E{len(group)}_C{n_cars}",
            [scs[n] for n in group], ts=120))

    # the portable engine: the whole battery, no kernel launch
    zero_counters()
    t0 = time.perf_counter()
    portable = parity.run_torch([scs[n] for n in names])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if counter("kernel.launches"):
        fail("parity: the portable route launched the kernel")
    print(f"[parity] portable route, 26 scenarios in 2 arena axes: "
          f"{PARITY_T} ticks in {wall:.1f} s "
          f"({wall / (2 * PARITY_T) * 1e3:.1f} ms a tick of a group); "
          f"card {card}")
    refs, oracle_s = oracle_run.result()
    pool.shutdown()
    print(f"[parity] oracle {os.path.relpath(parity.ORACLE_BIN, ROOT)} on "
          f"the host, beside the card's work: {len(names)} scenarios x "
          f"{PARITY_T} ticks in {oracle_s:.1f} s")
    kernel_errs = {n: parity_battery.errors(refs[n], traces[n])
                   for n in names}
    portable_errs = {n: parity_battery.errors(refs[n], tr)
                     for n, tr in zip(names, portable)}

    bad = []
    for route, errs in (("kernel", kernel_errs),
                        ("portable", portable_errs)):
        for n in names:
            parity_row(route, n, errs[n])
            if n in EXACT_ROWS:
                over = [k for k, m in MARGINS.items() if errs[n][k] > m]
                if over or errs[n]["flags"]:
                    bad.append((route, n, over, errs[n]["flags"]))
    if bad:
        fail(f"parity: PARITY.md's exact rows beyond the BallState::Matches "
             f"margins {MARGINS}: {bad}")
    print(f"[parity] PARITY.md's exact rows ({len(EXACT_ROWS)}) within "
          f"{MARGINS} on both routes, no flag differing")

    # the teacher-forced run through the kernel
    zero_counters()
    t0 = time.perf_counter()
    worst = parity_teacher.run("front_flip", PARITY_T, quiet=True,
                               backend="ctick")
    torch.cuda.synchronize()
    launches = counter("kernel.launches")
    if launches != PARITY_T - 1:
        fail(f"parity_teacher: {launches} kernel launches for "
             f"{PARITY_T - 1} teacher-forced ticks")
    print(f"[parity] teacher-forced front_flip --ctick: "
          f"{launches} launches in "
          f"{time.perf_counter() - t0:.1f} s; worst single-tick "
          + json.dumps({k: float(f"{v:.4g}") for k, v in worst.items()})
          + f" (PARITY.md, JAX: car_ang 0.46); card {card}")
    if not all(math.isfinite(v) for v in worst.values()):
        fail("parity_teacher: non-finite errors")
    return {f"E{len(groups[c])}_C{c}": entries[c] for c in sorted(groups)}


def profile_path(card):
    """The profilers' twins at the main path's width: profile_split at 1024
    x 2v2 and profile_phys's kernel routes at 256, each line printed with
    the card's name and power limit."""
    import contextlib
    import io
    from reinforcement_learning_torch.tools import profile_phys, profile_split
    for what, fn in (
            ("profile_split 1024", lambda: profile_split.profile(1024)),
            ("profile_phys 256 kernel kernel_mesh",
             lambda: profile_phys.main(256, ("kernel", "kernel_mesh")))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fn()
        for line in buf.getvalue().splitlines():
            print(f"[profile] {line}; card {card}")
        print(f"[profile] {what}: {time.perf_counter() - t0:.1f} s")
        vals = [v for r in res.values()
                for v in (r.values() if isinstance(r, dict) else [r])]
        if not all(math.isfinite(v) and v > 0 for v in vals):
            fail(f"profile: {what} gave {res}")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, ROOT)
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.ops import ctick
    from reinforcement_learning_torch.physics.step import ArenaParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    print(card)
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    so, log = A.build(verbose=True)
    release = subprocess.run([A.nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    release = [ln for ln in release.splitlines() if "release" in ln]
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s by nvcc "
          f"{release[0] if release else '(release unknown)'}")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers",
                                   "spill")):
            print(f"[build] {line.strip()}")
    shape = A.launch_shape(A._library(), E, CARS)
    print(f"[build] launch at E={E}, C={CARS}: "
          f"{shape['arenas_per_block']} arenas per block x "
          f"{shape['lanes_per_arena']} lanes per arena = "
          f"{shape['threads_per_block']} threads, {shape['blocks']} blocks; "
          f"4-car kernel: {ptxas_resources(log, 4)}, "
          f"{shape['shared_bytes_per_block']} bytes of shared memory per "
          "block (dynamic)")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    S = States(dev, gen)

    def controls():
        analog = torch.rand(E, CARS, 5, generator=gen, device=dev) * 2 - 1
        buttons = (torch.rand(E, CARS, 3, generator=gen, device=dev)
                   > 0.5).float()
        return torch.cat([analog, buttons], -1)

    def ridx():
        return torch.randint(0, 4, (E, CARS), generator=gen, device=dev,
                             dtype=torch.int32)

    one = int(THRESHOLD_SHARE * E)
    err = {"plane": 0.0, "full": 0.0}

    # 2. plane arena: kernel vs plain ------------------------------------
    plane = ArenaParams(num_cars=CARS, use_mesh=False,
                        dynamic_wheel_rays=False)
    penv = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, arena=plane,
                                     device="cuda"))
    teams = penv.teams_np
    state, _, _ = penv.reset(SEED)
    for _ in range(6):
        act = torch.randint(0, penv.num_actions, (E, CARS), generator=gen,
                            device=dev)
        state, _ = penv.step(state, act)
    phys_random = state.phys

    def respawned(phys, got, live):
        n = int((~got.arena.cars.is_demoed[:, 0]).sum())
        print(f"[demo_respawn] car 0 respawned in {n} of {E} arenas")
        if n == 0:
            fail("no car respawned in the demo phase")

    def demoed(phys, got, live):
        print(f"[car_car] bumps {int(got.arena.step_bump.sum())}, demos "
              f"{int(got.arena.step_demo.sum())}")
        if not bool(got.arena.step_demo.any()):
            fail("the car-car phase drove no demo")

    def ball_hit(phys, got, live):
        moved = int((got.arena.ball.vel.norm(dim=-1) > 0).sum())
        print(f"[car_ball] the resting ball was hit in {moved} of {E} "
              "arenas")
        if moved == 0:
            fail("the car-ball phase drove no touch")

    def walled(phys, got, live):
        along = (torch.arange(E, device=dev) % 2)[:, None]
        bounced = int((phys.arena.ball.vel.gather(1, along)
                       * got.arena.ball.vel.gather(1, along) < 0).sum())
        hit = int((got.arena.cars.world_contact_normal[:, 1, 0].abs()
                   > 0.5).sum())
        print(f"[walls] the ball bounced off a wall in {bounced} arenas, "
              f"car 1 touched a side wall in {hit}, goals "
              f"{int(got.arena.goal_scored.sum())}")
        if not (bounced and hit):
            fail("the wall phase drove no wall contact")

    for name, phys, allowed, check in (
            ("random_steps", phys_random, one, None),
            ("demo_respawn", S.demo(phys_random), 0, respawned),
            ("car_car", S.overlap(phys_random), 0, demoed),
            ("car_ball", S.car_ball(phys_random), one, ball_hit),
            ("walls", S.walls(phys_random), one, walled)):
        err["plane"] = max(err["plane"], kernel_vs_plain(
            name, phys, plane, teams, controls(), ridx(), allowed, check))

    # 3. full fidelity: kernel vs plain ----------------------------------
    fenv = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2,
                                     device="cuda"))
    full = fenv.params
    if not (full.use_mesh and full.dynamic_wheel_rays):
        fail("the default EnvConfig is not full fidelity")
    fconsts = A._consts(full, tuple(int(t) for t in teams))
    state, _, _ = fenv.reset(SEED + 1)
    for _ in range(6):
        act = torch.randint(0, fenv.num_actions, (E, CARS), generator=gen,
                            device=dev)
        state, _ = fenv.step(state, act)
    phys_full = state.phys

    def fillet_bounced(phys, got, live):
        # falling at least 28 uu above the floor, the ball can turn both
        # up and back only off the fillet's curved facets: the floor does
        # not reach it and the side wall's plane has no z component
        vin, vout = phys.arena.ball.vel, got.arena.ball.vel
        up_back = (vout[:, 2] > 0) & (vout[:, 0] * vin[:, 0] < 0)
        touching = live.ball > 0
        print(f"[fillet_ball] the ball bounced up and back in "
              f"{int(up_back.sum())} of {E} arenas; a facet slot occupied "
              f"in the step: {int(touching.sum())}")
        if min(int(up_back.sum()), int(touching.sum())) < E // 2:
            fail("the fillet phase drove no fillet bounce")

    def ground_of(phys, car):
        """(4, E): the body each wheel ray of ``car`` stands on, by the
        plain version's raycast of ``phys`` (-1 world or none, -2 the
        ball, j car j)."""
        from reinforcement_learning_torch.ops import cvec, pack
        st = pack.to_components(phys)
        iw = cvec.inv_inertia_world(st["rot"], fconsts.inv_i_local)
        rc = ctick._wheel_raycasts(fconsts, st, iw)
        return torch.stack(rc["ground_idx"])[:, car]

    def on_wall(phys, got, live):
        # no true plane has a y component: only the facet raycast holds
        # the wheels on a back wall
        cars = got.arena.cars
        wc = cars.wheels_with_contact[:, 1].all(-1)
        high = (cars.pos[:, 1, 1].abs() > 4950) & (cars.pos[:, 1, 2] > 300)
        print(f"[wall_drive] car 1 on all 4 wheels high on a back wall in "
              f"{int((wc & high).sum())} of {E} arenas")
        if int((wc & high).sum()) < E // 2:
            fail("the wall-drive phase drove no wall ride")

    def box_walled(phys, got, live):
        # the world contact normal is the mean of the live rows' normals;
        # no true plane has a y component, so one pointing off the back
        # wall came from the facet box manifold
        sy = torch.sign(phys.arena.cars.pos[:, 2, 1])
        n = got.arena.cars.world_contact_normal[:, 2]
        hit = int((n[:, 1] * sy < -0.5).sum())
        slots = int((live.cars[2] > 0).sum())
        print(f"[box_wall] car 2's hitbox met a back wall's facets in {hit} "
              f"of {E} arenas; a facet slot occupied in the step: {slots}")
        if min(hit, slots) < E // 2:
            fail("the box-wall phase drove no facet box contact")

    def overflowed(phys, got, live):
        # the kernel's retention replays a buffer of 8 live candidates and
        # enumerates them again when there are more
        vin, vout = phys.arena.ball.vel, got.arena.ball.vel
        back = int(((vout[:, :2] * vin[:, :2]).sum(-1) < 0).sum())
        slots = int((live.ball > 0).sum())
        many = int((live.ball > 8).sum())
        print(f"[corner_ball] the ball came back out of the corner in {back} "
              f"of {E} arenas; a facet slot occupied in the step: {slots}; "
              f"more than 8 live facet candidates at a tick: {many}")
        if slots < E // 2 or many < E // 8:
            fail("the corner phase drove too few corner contacts with more "
                 "than 8 live candidates")

    def netted(phys, got, live):
        # no true plane has a y component: only the facets (back net,
        # back wall, crossbar) turn the ball back along y
        back = phys.arena.ball.vel[:, 1] * got.arena.ball.vel[:, 1] < 0
        touching = live.ball > 0
        print(f"[goal_mouth] the ball came back off the net or crossbar in "
              f"{int(back.sum())} of {E} arenas; a facet slot occupied in "
              f"the step: {int(touching.sum())}; goals "
              f"{int(got.arena.goal_scored.sum())}")
        if min(int(back.sum()), int(touching.sum())) < E // 2:
            fail("the goal-mouth phase drove no net or crossbar contact")

    def on_ball(phys, got, live):
        cars = got.arena.cars
        # 200 uu up, only the ball is within the wheel rays' reach
        stand = cars.wheels_with_contact[:, 0].any(-1) & (cars.pos[:, 0, 2]
                                                          > 150)
        on = (ground_of(phys, 0) == -2).any(0)
        print(f"[car_on_ball] car 0's wheels stand on the ball in "
              f"{int(stand.sum())} of {E} arenas; a wheel ray's ground body "
              f"is the ball in {int(on.sum())}")
        if min(int(stand.sum()), int(on.sum())) < E // 2:
            fail("the car-on-ball phase drove no wheel on the ball")

    def on_roof(phys, got, live):
        cars = got.arena.cars
        # 75-85 uu up, only car 0's roof is within the wheel rays' reach
        stand = cars.wheels_with_contact[:, 1].any(-1) & (cars.pos[:, 1, 2]
                                                          > 60)
        on = (ground_of(phys, 1) == 0).any(0)
        print(f"[car_on_car] car 1's wheels stand on car 0's roof in "
              f"{int(stand.sum())} of {E} arenas; a wheel ray's ground body "
              f"is car 0 in {int(on.sum())}")
        if min(int(stand.sum()), int(on.sum())) < E // 2:
            fail("the car-on-car phase drove no wheel on a car")

    ctl_still = torch.zeros(E, CARS, 8, device=dev)
    ctl_drive = ctl_still.clone()
    ctl_drive[:, 1, 0] = 1.0
    for name, phys, ctl, check in (
            ("fillet_ball", S.fillet_ball(phys_full), controls(),
             fillet_bounced),
            ("wall_drive", S.wall_drive(phys_full), ctl_drive, on_wall),
            ("box_wall", S.box_wall(phys_full, fconsts.half_extents[1]),
             ctl_still, box_walled),
            ("corner_ball", S.corner_ball(phys_full), controls(),
             overflowed),
            ("goal_mouth", S.goal_mouth(phys_full), controls(), netted),
            ("car_on_ball", S.car_on_ball(phys_full), ctl_still, on_ball),
            ("car_on_car", S.car_on_car(phys_full), ctl_still, on_roof)):
        err["full"] = max(err["full"], kernel_vs_plain(
            name, phys, full, teams, ctl, ridx(), one, check))

    # 4. game modes: kernel vs plain -------------------------------------
    def mode_state(mode, seed):
        env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2,
                                        game_mode=mode, device="cuda"))
        st, _, _ = env.reset(seed)
        for _ in range(6):
            act = torch.randint(0, env.num_actions, (E, CARS),
                                generator=gen, device=dev)
            st, _ = env.step(st, act)
        return env.params, st.phys

    def share(mask):
        return int(mask.sum()), float(mask.float().mean())

    def event(name, what, mask):
        n, frac = share(mask)
        print(f"[{name}] {what} in {n} of {E} arenas")
        if frac < 0.9:
            fail(f"{name}: {what} in only {n} of {E} arenas (90% needed)")

    def touched(phys, out):
        """(E, C): the car touched the ball during the step."""
        cars = out.arena.cars
        return cars.ball_hit_valid & (cars.ball_hit_tick
                                      >= phys.arena.tick_count[:, None])

    def steered(phys, got, live):
        ball, want = phys.arena.ball, live.want.arena.ball
        dt = 8 / 120.0
        ran = (want.hs_time_since_hit - ball.hs_time_since_hit
               - dt).abs() < 1e-4
        event("hs_steer", "the ball steered every tick, untouched",
              ran & ~touched(phys, live.want).any(-1))

    def both_touched(phys, got, live):
        # the plain step's first tick: car 0 (blue) and car 2 (orange)
        # both touch the ball, the state's touches being older
        tick0 = phys.arena.tick_count[:, None]
        z = torch.zeros(E, CARS, 8, device=dev)
        r0 = torch.zeros(E, CARS, dtype=torch.int32, device=dev)
        one = ctick.arena_step_reference(phys, z, r0, hs_consts, 1, 0)
        c1 = one.arena.cars
        both_first = (c1.ball_hit_valid[:, [0, 2]]
                      & (c1.ball_hit_tick[:, [0, 2]] == tick0)).all(-1)
        ball0, ball1 = phys.arena.ball, one.arena.ball
        within = ball0.hs_time_since_hit < 1.0
        print(f"[hs_touch] last hit within the minimum speed-up interval "
              f"in {int(within.sum())} arenas; target speed raised in the "
              f"first tick in "
              f"{int((ball1.hs_target_speed > ball0.hs_target_speed).sum())}"
              f"; target set by orange in "
              f"{int((ball1.hs_y_target_dir == -1).sum())}")
        event("hs_touch", "both teams first touched the ball in the same "
              "tick", both_first)

    def flipped(name):
        def check(phys, got, live):
            event(name, "a back-wall hit flipped the target",
                  live.want.arena.ball.hs_y_target_dir
                  == -phys.arena.ball.hs_y_target_dir)
        return check

    def on_floor(phys, got, live):
        event("snow_floor", "the puck touched the floor (ground stick)",
              live.snow.floor)

    def on_wall(phys, got, live):
        event("snow_wall", "the puck touched a side or corner wall",
              live.snow.wall)

    hs_full, phys_hs = mode_state("heatseeker", SEED + 2)
    snow_full, phys_snow = mode_state("snowday", SEED + 3)
    if not (hs_full.use_mesh and snow_full.use_mesh):
        fail("the game-mode envs are not full fidelity")
    hs_plane = ArenaParams(num_cars=CARS, use_mesh=False,
                           dynamic_wheel_rays=False, game_mode="heatseeker")
    hs_consts = A._consts(hs_full, tuple(int(t) for t in teams))
    err["heatseeker"] = err["snowday"] = 0.0
    for name, mode, phys, params, ctl, check in (
            ("hs_steer", "heatseeker", S.hs_flight(phys_hs), hs_full,
             controls(), steered),
            ("hs_touch", "heatseeker", S.hs_touch(phys_hs), hs_full,
             ctl_still, both_touched),
            ("hs_backwall", "heatseeker", S.hs_backwall(phys_hs), hs_full,
             ctl_still, flipped("hs_backwall")),
            ("hs_backwall_plane", "heatseeker", S.hs_backwall(phys_hs),
             hs_plane, ctl_still, flipped("hs_backwall_plane")),
            ("snow_floor", "snowday", S.snow_floor(phys_snow), snow_full,
             ctl_still, on_floor),
            ("snow_wall", "snowday", S.snow_wall(phys_snow), snow_full,
             ctl_still, on_wall)):
        err[mode] = max(err[mode], kernel_vs_plain(
            name, phys, params, teams, ctl, ridx(), 0, check))

    # 5. the collection paths --------------------------------------------
    entries = {}
    for label, env, params in (("plane", penv, plane), ("full", fenv, full)):
        entries[label] = drive_path(label, env, params, card, gen, T,
                                    record=label == "full")
        err[label] = max(err[label], entries[label].pop("end_err"))
    positions = entries["full"].pop("positions")
    played = entries["full"].pop("played")
    del penv, fenv

    # 6. the main path: train_iteration at bench shape --------------------
    entries["full"]["launches"], bench, first = train_path(card, gen)

    # 7. one train_iteration in each game mode ---------------------------
    for mode in ("heatseeker", "snowday"):
        entries[mode] = mode_path(mode, mode, card, gen)
        err[mode] = max(err[mode], entries[mode].pop("end_err"))

    # 8. the canonical training program: train_2v2 and train_1v1 twins ---
    entries["train_2v2"], twin = twin_path(card, gen)

    # 9. deployment: InferUnit, the C++ runtime, the bot server, the
    # converter ------------------------------------------------------------
    t0 = time.perf_counter()
    deploy_path(card, bench, twin)
    print(f"[deploy] phase {time.perf_counter() - t0:.1f} s")
    del bench, twin

    # 10. the arena geometry: mesh grids, queries, box-box ----------------
    t0 = time.perf_counter()
    geometry_path(card, gen, positions)
    print(f"[geometry] phase {time.perf_counter() - t0:.1f} s")

    # 11-13. the portable physics engine: soccar, hoops, ball prediction
    t0 = time.perf_counter()
    portable_path(card, gen, played)
    print(f"[portable] phase {time.perf_counter() - t0:.1f} s")
    del played
    t0 = time.perf_counter()
    hoops_played = hoops_path(card, gen)
    print(f"[hoops] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ball_pred_path(card, hoops_played, "hoops")
    print(f"[ball_pred] phase {time.perf_counter() - t0:.1f} s")
    del hoops_played

    # 14. small collection on the card vs the plain path on the CPU ------
    small_collect_agrees(dev, full)

    # 15. data parallelism: the main path on one NCCL rank and on two gloo
    # ranks sharing the card, against the unsharded run -------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    entries["parallel"] = parallel_path(card, first)
    print(f"[parallel] phase {time.perf_counter() - t0:.1f} s")

    # 16. the parity instruments: the battery through the oracle, the
    # kernel and the portable engine; the kernel at the battery's shape
    t0 = time.perf_counter()
    battery = parity_path(card)
    print(f"[parity] phase {time.perf_counter() - t0:.1f} s")

    # 17. the profilers: the main path's split, the physics probe --------
    t0 = time.perf_counter()
    profile_path(card)
    print(f"[profile] phase {time.perf_counter() - t0:.1f} s")

    kernels = []
    for label, what, where in (
            ("plane", "soccar, plane arena", "pallas_step.py:126"),
            ("full", "soccar, full fidelity: facet arena, dynamic wheel "
                     "rays", "pallas_step.py:126"),
            ("heatseeker", "heatseeker, full fidelity", "ctick.py:2415"),
            ("snowday", "snowday, full fidelity", "ctick.py:1485")):
        kernels.append({
            "name": f"arena_step ({what})", "route": "cuda",
            "source": "reinforcement_learning_torch/csrc/arena_step.cu",
            "replaces": f"reinforcement_learning_tpu/ops/{where}",
            **entries[label], "max_abs_err": err[label],
            "library_ms": None})
    kernels.append({
        "name": "arena_step (soccar, full fidelity: train_2v2, 512 x 2v2, "
                "13-term rewards, self-play with skill matches at 16 "
                "arenas)", "route": "cuda",
        "source": "reinforcement_learning_torch/csrc/arena_step.cu",
        "replaces": "reinforcement_learning_tpu/ops/pallas_step.py:126",
        **entries["train_2v2"], "library_ms": None})
    kernels.append({
        "name": "arena_step (soccar, full fidelity: the data-parallel main "
                "path, one of 2 ranks sharing the card, 512 of 1024 "
                "arenas; launches per rank)", "route": "cuda",
        "source": "reinforcement_learning_torch/csrc/arena_step.cu",
        "replaces": "reinforcement_learning_tpu/ops/pallas_step.py:126",
        **entries["parallel"], "library_ms": None})
    for key, what in (("E24_C1", "24 one-car scenarios"),
                      ("E2_C2", "2 two-car scenarios")):
        kernels.append({
            "name": f"arena_step (soccar, full fidelity: the parity "
                    f"battery, {what} as one arena axis, tick_skip 1, "
                    f"action_delay 0)", "route": "cuda",
            "source": "reinforcement_learning_torch/csrc/arena_step.cu",
            "replaces": "reinforcement_learning_tpu/ops/pallas_step.py:126",
            **battery[key], "library_ms": None})
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
