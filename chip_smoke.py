#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check its kernel.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, each of which must pass (nothing is caught):

1. build the arena-step kernel (csrc/arena_step.cu) with nvcc for sm_90a;
2. hold the kernel against its plain PyTorch version (ops/ctick.py) on the
   card at E=1024 arenas x 4 cars, plane arena, from five states: a few
   random env steps after kickoff, demolished cars respawning mid-step,
   opposing cars overlapping (bumps and demos), a car driving into the
   ball, and the ball and a car flying into the walls and the goal
   openings;
3. the main path: ``RocketLeagueEnv`` 1024 x 2v2 and a ``PPOLearner`` at
   the bench widths in bf16, ``Trainer.collect`` for 24 env steps, with
   the kernel's launch count read around that run; then the kernel held
   against the plain version on the state the collection ends in, the
   plain run counting the work those inputs need for the kernel's bound
   (ops/opcount.py), and the kernel, the plain version and the
   collection timed;
4. the same collection at 8 arenas on the card against the plain path on
   the CPU, deterministic actions, fp32.

Prints the card's name and power limit, a ``kernels`` JSON line, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero without a
CUDA card or without the repository beside it.
"""

from __future__ import annotations

import json
import os
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


def compare(name, got, want, allowed_arenas):
    """Hold kernel output ``got`` to the plain version's ``want`` field by
    field.  Arenas where an integer or boolean field differs are listed;
    at most ``allowed_arenas`` may, and their floats are not compared.
    Returns the worst float deviation."""
    import torch
    from reinforcement_learning_torch.ops.ctick import (DEFAULT_TOLERANCE,
                                                        TOLERANCES)
    g, w = flatten(got), flatten(want)
    bad = torch.zeros(E, dtype=torch.bool, device=g["arena.tick_count"].device)
    flips = {}
    for k, a in w.items():
        if a.dtype.is_floating_point:
            continue
        d = (g[k] != a).reshape(E, -1).any(-1)
        if d.any():
            flips[k] = d.nonzero()[:, 0].tolist()
        bad |= d
    n_bad = int(bad.sum())
    print(f"[{name}] arenas with a differing boolean/int: {n_bad} "
          f"{json.dumps(flips)}")
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
        atol, rtol = TOLERANCES.get(k, DEFAULT_TOLERANCE)
        lim = atol + rtol * a[ok].abs()
        if bool((dev > lim).any()) or not bool(torch.isfinite(b).all()):
            fail(f"{name}: {k} off by {worst[k]:.3g} (atol {atol}, rtol "
                 f"{rtol})")
    print(f"[{name}] worst |kernel - plain| per field: "
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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, ROOT)
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.ops import ctick, opcount
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
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers",
                                   "spill")):
            print(f"[build] {line.strip()}")
    lib = A._library()

    # 2. kernel vs plain ------------------------------------------------
    params = ArenaParams(num_cars=CARS, use_mesh=False,
                         dynamic_wheel_rays=False)
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, arena=params,
                                    device="cuda"))
    teams = env.teams_np
    consts = A._consts(params, tuple(int(t) for t in teams))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state, _, masks = env.reset(SEED)
    for _ in range(6):
        act = torch.randint(0, env.num_actions, (E, CARS), generator=gen,
                            device=dev)
        state, _ = env.step(state, act)
    phys_random = state.phys

    def controls():
        analog = torch.rand(E, CARS, 5, generator=gen, device=dev) * 2 - 1
        buttons = (torch.rand(E, CARS, 3, generator=gen, device=dev)
                   > 0.5).float()
        return torch.cat([analog, buttons], -1)

    def ridx():
        return torch.randint(0, 4, (E, CARS), generator=gen, device=dev,
                             dtype=torch.int32)

    def demo_state(phys):
        from reinforcement_learning_torch.device import tree_map
        phys = tree_map(lambda t: t.clone(), phys)
        cars = phys.arena.cars
        demoed = torch.zeros_like(cars.is_demoed)
        demoed[:, 0] = demoed[:, 3] = True
        ticks = torch.randint(1, 10, (E, CARS), generator=gen, device=dev)
        cars.is_demoed = demoed
        cars.demo_respawn_timer = torch.where(demoed, ticks / 120.0, 0.0)
        return phys

    def overlap_state(phys):
        """Car 0 drives into car 2 and car 3 into car 1, nearly head-on,
        hitboxes a few uu into each other; half the attackers are
        supersonic."""
        from reinforcement_learning_torch import maths
        from reinforcement_learning_torch.device import tree_map
        phys = tree_map(lambda t: t.clone(), phys)
        cars = phys.arena.cars
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            E, generator=gen, device=dev)
        for att, vic, y0 in ((0, 2, -1500.0), (3, 1, 1500.0)):
            x0 = u(-2000, 2000)
            ya, yv = u(-0.15, 0.15), torch.pi + u(-0.15, 0.15)
            fast = torch.arange(E, device=dev) % 2 == 0
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

    def car_ball_state(phys):
        """Car 0 drives into the resting ball from about 150 uu behind it,
        a little off centre; the ball anywhere on the field."""
        from reinforcement_learning_torch.device import tree_map
        phys = tree_map(lambda t: t.clone(), phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            E, generator=gen, device=dev)
        bx, by = u(-3000, 3000), u(-4000, 4000)
        ball.pos = torch.stack([bx, by, torch.full_like(bx, 93.15)], -1)
        ball.vel = torch.zeros_like(ball.vel)
        ball.ang_vel = torch.zeros_like(ball.ang_vel)
        cars.pos[:, 0] = torch.stack([bx - 150 + u(-10, 20), by + u(-30, 30),
                                      torch.full_like(bx, 17.0)], -1)
        cars.vel[:, 0] = torch.stack([u(800, 1600), 0 * bx, 0 * bx], -1)
        cars.rot[:, 0] = torch.eye(3, device=dev)
        cars.ang_vel[:, 0] = 0.0
        cars.is_demoed[:, 0] = False
        return phys

    def wall_state(phys):
        """The ball flies into a side wall (even arenas) or a back wall,
        into the goal where it meets the opening; car 1 drives into a side
        wall and car 2 falls onto the floor from above."""
        from reinforcement_learning_torch.device import tree_map
        phys = tree_map(lambda t: t.clone(), phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            E, generator=gen, device=dev)
        sign = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        side = torch.arange(E, device=dev) % 2 == 0
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
        from reinforcement_learning_torch import maths
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

    max_err = 0.0
    one_share = int(THRESHOLD_SHARE * E)
    cases = (("random_steps", phys_random, one_share),
             ("demo_respawn", demo_state(phys_random), 0),
             ("car_car", overlap_state(phys_random), 0),
             ("car_ball", car_ball_state(phys_random), one_share),
             ("walls", wall_state(phys_random), one_share))
    for name, phys, allowed in cases:
        ctl, r = controls(), ridx()
        got = A.arena_step(phys, ctl, r, params, teams)
        want = ctick.arena_step_reference(phys, ctl, r, consts)
        torch.cuda.synchronize()
        if name == "demo_respawn":
            respawned = ~got.arena.cars.is_demoed[:, 0]
            print(f"[{name}] car 0 respawned in {int(respawned.sum())} of "
                  f"{E} arenas")
            if not bool(respawned.any()):
                fail("no car respawned in the demo phase")
        if name == "car_car":
            print(f"[{name}] bumps {int(got.arena.step_bump.sum())}, "
                  f"demos {int(got.arena.step_demo.sum())}")
            if not bool(got.arena.step_demo.any()):
                fail("the car-car phase drove no demo")
        if name == "car_ball":
            moved = got.arena.ball.vel.norm(dim=-1) > 0
            print(f"[{name}] the resting ball was hit in {int(moved.sum())} "
                  f"of {E} arenas")
            if not bool(moved.any()):
                fail("the car-ball phase drove no touch")
        if name == "walls":
            along = (torch.arange(E, device=dev) % 2)[:, None]
            bounced = (phys.arena.ball.vel.gather(1, along)
                       * got.arena.ball.vel.gather(1, along) < 0)
            walled = got.arena.cars.world_contact_normal[:, 1, 0].abs() > 0.5
            print(f"[{name}] the ball bounced off a wall in "
                  f"{int(bounced.sum())} arenas, car 1 touched a side wall "
                  f"in {int(walled.sum())}, goals "
                  f"{int(got.arena.goal_scored.sum())}")
            if not (bool(bounced.any()) and bool(walled.any())):
                fail("the wall phase drove no wall contact")
        max_err = max(max_err, compare(name, got, want, allowed))

    # 3. the main path --------------------------------------------------
    ppo_cfg = PPOConfig(policy_layers=(384, 384, 384),
                        critic_layers=(384, 384, 384),
                        shared_head_layers=(384, 384), half_precision=True)
    trainer = Trainer(env, ppo_cfg, TrainerConfig(ts_per_itr=100_000,
                                                  random_seed=SEED))
    if trainer.steps_per_itr != T:
        fail(f"steps_per_itr {trainer.steps_per_itr} != {T}")
    print(f"[main] params {trainer.learner.param_counts()}")
    tstate = trainer.init(SEED)
    tstate, _ = trainer.collect(tstate, T)            # warm-up
    torch.cuda.synchronize()
    A.arena_step.launches = 0
    t0 = time.perf_counter()
    tstate, traj = trainer.collect(tstate, T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.arena_step.launches
    if launches != T:
        fail(f"arena_step launched {launches} times in {T} env steps")
    P = CARS
    shapes = dict(obs=(T, E, P, env.obs_size), mask=(T, E, P, 90),
                  action=(T, E, P), old_logp=(T, E, P), reward=(T, E, P),
                  terminal=(T, E), final_obs=(T, E, P, env.obs_size),
                  goal=(T, E), touch=(T, E, P))
    for k, shp in shapes.items():
        v = traj[k]
        if tuple(v.shape) != shp:
            fail(f"traj[{k!r}] shape {tuple(v.shape)} != {shp}")
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            fail(f"traj[{k!r}] holds NaN or inf")
    chosen_ok = torch.gather(traj["mask"], -1, traj["action"][..., None])
    if not bool(chosen_ok.all()):
        fail("an action outside its mask was sampled")
    if not bool((traj["old_logp"] <= 0).all()):
        fail("log-probabilities above 0")
    steps_per_s = T * E * P / wall
    print(f"[main] collect: {T} env steps x {E} arenas x {P} players in "
          f"{wall:.3f} s = {steps_per_s:.0f} player-steps/s; "
          f"launches {launches}; goals {int(traj['goal'].sum())}, "
          f"touches {int(traj['touch'].sum())}")

    # kernel vs plain on the state the collection ends in; the plain run
    # counts the work these inputs need
    phys = tstate.env_states.phys
    ctl = env.action_parser.parse(traj["action"][-1])
    r = ridx()
    work = opcount.step_work(phys, ctl, r, consts)
    got = A.arena_step(phys, ctl, r, params, teams)
    torch.cuda.synchronize()
    max_err = max(max_err, compare("main_state", got, work.out, one_share))
    print("[work] fp32 ops per env step, needed / branch-free: "
          + json.dumps({k: [float(f"{n:.4g}"), float(f"{b:.4g}")]
                        for k, (n, b) in work.by_gate.items()}))

    # kernel time alone, on the main path's state and shapes
    f, i, u = A._pack(phys)
    ctl_k = ctl.permute(2, 1, 0).contiguous()
    r_k = r.transpose(0, 1).contiguous()
    outs = [torch.empty_like(x) for x in (f, i, u)]
    prm = A.pack_params(params, tuple(int(t) for t in teams))
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        err = lib.arena_step_launch(
            prm.ctypes.data, prm.nbytes, f.data_ptr(), i.data_ptr(),
            u.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), ctl_k.data_ptr(), r_k.data_ptr(), E, CARS,
            8, 7, stream)
        if err:
            fail(f"kernel launch error {err}")
    kernel_ms = cuda_ms(raw, reps=20, warmup=3)
    wrapper_ms = cuda_ms(lambda: A._launch(lib, phys, ctl, r, params,
                                           tuple(int(t) for t in teams), 8,
                                           7, stream), reps=10)
    plain_ms = cuda_ms(lambda: ctick.arena_step_reference(phys, ctl, r,
                                                          consts), reps=2)
    flat_obs = tstate.obs.reshape(E * P, -1)
    flat_mask = tstate.masks.reshape(E * P, -1)
    policy_ms = cuda_ms(lambda: trainer.learner.sample_actions(
        flat_obs, flat_mask, generator=gen), reps=10)
    env_ms = cuda_ms(lambda: env.step(tstate.env_states, traj["action"][-1]),
                     reps=10)
    policy_calls = opcount.count_ops(lambda: trainer.learner.sample_actions(
        flat_obs, flat_mask, generator=gen))[1]
    env_calls = opcount.count_ops(lambda: env.step(tstate.env_states,
                                           traj["action"][-1]))[1]
    print(f"[time] per env step: collect {wall / T * 1e3:.3f} ms (host "
          f"clock); policy sample {policy_ms:.3f} ms, env.step "
          f"{env_ms:.3f} ms of which arena_step {wrapper_ms:.3f} ms "
          f"(kernel {kernel_ms:.3f} ms) (CUDA events); tensor ops "
          f"dispatched: policy sample {policy_calls}, env.step {env_calls}")
    nbytes = sum(x.numel() * x.element_size()
                 for x in (f, i, u, *outs, ctl_k, r_k))
    ops = work.ops_needed
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[time] kernel {kernel_ms:.4f} ms/env step (E={E}, C={CARS}); "
          f"with pack/unpack {wrapper_ms:.4f} ms; plain version "
          f"{plain_ms:.2f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"({nbytes} bytes -> {bytes_ms:.5f} ms, {ops:.4g} fp32 ops "
          f"these inputs need -> {ops_ms:.5f} ms; the branch-free plain "
          f"version runs {work.ops_branch_free:.4g}); card {card}")

    # 4. small collection on the card vs the plain path on the CPU ------
    small_collect_agrees(dev, params)

    kernels = [{
        "name": "arena_step", "route": "cuda",
        "source": "reinforcement_learning_torch/csrc/arena_step.cu",
        "replaces": "reinforcement_learning_tpu/ops/pallas_step.py:126",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
