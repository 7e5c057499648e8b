#!/usr/bin/env python3
"""The physics kernel's times on an NVIDIA card, on the states the programs
drive it into, beside its plain version and its bound.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
For each configuration below the port is driven through its own entry
points with the tracer's counters zeroed (``tracing.reset()``) before, and
the kernel's launches read after; then, on the state the run ends in, the
kernel (``ops/arena_step.py``) and its plain PyTorch version
(``ops/ctick.py``) step the same state, controls and respawn draws, held to
``ops.ctick.TOLERANCES`` (the battery's to ``DEFAULT_TOLERANCE``) with at
most the allowed arenas differing in a flag, and there the kernel alone
(CUDA events over 10 launches), the plain version (one call) and the bound
are measured.  The bound is the larger of the launch's bytes over the
card's memory rate and the fp32 ops those inputs need (``ops/opcount.py``)
over its fp32 rate.

- ``plane``, ``full``, ``heatseeker``, ``snowday``: the main path's width,
  1024 x 2v2 (``Trainer.collect`` of 24 env steps after as many of
  warm-up, a learner of the bench widths), on the plane arena and at full
  fidelity in each game mode;
- ``train_2v2``, ``skill_match``, ``train_1v1``, ``train_3v3``: the
  examples' envs at their widths, 512 x 2v2, a skill match's 16 x 2v2,
  256 x 1v1 and 512 x 3v3 (the 6-car kernel), ``env.step`` for 300 env
  steps from kickoff, the even arenas driving at the ball with boost and
  the odd ones on random actions;
- ``battery_1``, ``battery_2``: the parity battery's launch shapes (its 24
  one-car scenarios, its 2 two-car ones, each as one arena axis, tick_skip
  1, action delay 0), at tick 120 of 240.

Prints the card's name and power limit, then a ``kernels`` JSON line with
one entry a configuration.  The checks of the port on the card are the
card tests (``tests/torch_card.py`` has their command); the end-to-end
and per-layer metrics are the benchmark's (``perfbench/run.py``).  Exits
non-zero without a CUDA card, or where a launch count or a comparison
fails.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch

from bench_torch import card
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.examples import (train_1v1, train_2v2,
                                                   train_3v3)
from reinforcement_learning_torch.learn.selfplay import SkillTracker
from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.ops import ctick, opcount
from reinforcement_learning_torch.physics.step import ArenaParams
from reinforcement_learning_torch.tools import parity_battery
from reinforcement_learning_torch.utils import tracing
from torch_card import (CARS, SEED, E, T, battery_group,
                        collect_at_bench_width, compare, counter,
                        forward_or_random, respawn_draws)

# H100 SXM (NVIDIA data sheet): HBM rate, fp32 rate outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PLAYED_STEPS = 300        # env steps before the examples' end states
BATTERY_T, BATTERY_TICK = 240, 120


def cuda_ms(fn, reps, warmup=1):
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
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


def raw_kernel(phys, controls, respawn_idx, params, teams, tick_skip,
               action_delay):
    """(a function launching the kernel alone on the packed buffers of
    ``phys``, the bytes the launch reads and writes)."""
    lib = A._library()
    n, cars = phys.cars.boost.shape
    f, i, u = A._pack(phys)
    ctl = controls.permute(2, 1, 0).contiguous()
    ridx = respawn_idx.transpose(0, 1).contiguous()
    outs = [torch.empty_like(x) for x in (f, i, u)]
    prm = A.pack_params(params, teams)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.arena_step_launch(
            prm.ctypes.data, prm.nbytes, f.data_ptr(), i.data_ptr(),
            u.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), ctl.data_ptr(), ridx.data_ptr(), n, cars,
            tick_skip, action_delay, stream)
        if err:
            raise RuntimeError(f"arena_step kernel launch failed: {err}")
    nbytes = sum(x.numel() * x.element_size()
                 for x in (f, i, u, *outs, ctl, ridx))
    return launch, nbytes


def measure(phys, controls, respawn_idx, params, teams, allowed,
            tick_skip=8, action_delay=7, tolerance=None):
    """The kernel against the plain version on these inputs, the plain run
    counting the work they need; the kernel's and the plain version's ms
    and the bound there."""
    teams = tuple(int(t) for t in teams)
    consts = A._consts(params, teams)
    work = opcount.step_work(phys, controls, respawn_idx, consts, tick_skip,
                             action_delay)
    got = A.arena_step(phys, controls, respawn_idx, params, teams,
                       tick_skip, action_delay)
    err = compare(got, work.out, allowed, tolerance=tolerance)
    launch, nbytes = raw_kernel(phys, controls, respawn_idx, params, teams,
                                tick_skip, action_delay)
    ms = cuda_ms(launch, reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: ctick.arena_step_reference(
        phys, controls, respawn_idx, consts, tick_skip, action_delay),
        reps=1, warmup=0)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = work.ops_needed / PEAK_FP32_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


def main_path_entries(gen):
    """``plane``, ``full``, ``heatseeker``, ``snowday``."""
    plane = ArenaParams(num_cars=CARS, use_mesh=False,
                        dynamic_wheel_rays=False)
    for label, what, kw in (
            ("plane", "soccar, plane arena", dict(arena=plane)),
            ("full", "soccar, full fidelity: facet arena, dynamic wheel "
                     "rays", {}),
            ("heatseeker", "heatseeker, full fidelity",
             dict(game_mode="heatseeker")),
            ("snowday", "snowday, full fidelity", dict(game_mode="snowday"))):
        env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2,
                                        device="cuda", **kw))
        run = collect_at_bench_width(env)
        if run["launches"] != T:
            raise SystemExit(f"{label}: {run['launches']} launches in {T} "
                             "env steps")
        phys = run["state"].env_states.phys
        controls = env.action_parser.parse(run["traj"]["action"][-1])
        yield label, f"{what}, {E} x 2v2, the end of a {T}-step collection", {
            "launches": run["launches"],
            **measure(phys, controls, respawn_draws(gen, E, CARS),
                      env.params, env.teams_np, 1)}


def example_entries(gen):
    """``train_2v2``, ``skill_match``, ``train_1v1``, ``train_3v3``."""
    skill = train_2v2.selfplay_config().skill
    for label, what, make, allowed in (
            ("train_2v2", "train_2v2's env",
             lambda: train_2v2.make_env(512, device="cuda"), 1),
            ("skill_match", "a skill match's env",
             lambda: SkillTracker(None, 2, skill, device="cuda").env, 1),
            ("train_1v1", "train_1v1's env",
             lambda: train_1v1.make_env(device="cuda"), 1),
            ("train_3v3", "train_3v3's env, the 6-car kernel",
             lambda: train_3v3.make_env(512, device="cuda"), 0)):
        env = make()
        n, cars = env.config.num_envs, env.config.cars_per_arena
        what = f"{what}, {n} x {cars // 2}v{cars // 2}"
        state, _, _ = env.reset(SEED)
        tracing.reset()
        for _ in range(PLAYED_STEPS):
            idx = forward_or_random(env, gen)
            state, _ = env.step(state, idx)
        launches = counter("kernel.launches")
        if launches != PLAYED_STEPS:
            raise SystemExit(f"{label}: {launches} launches in "
                             f"{PLAYED_STEPS} env steps")
        controls = env.action_parser.parse(forward_or_random(env, gen))
        entry = measure(state.phys, controls, respawn_draws(gen, n, cars),
                        env.params, env.teams_np, allowed)
        yield label, (f"soccar, full fidelity: {what}, after {PLAYED_STEPS} "
                      "env steps"), {"launches": launches, **entry}


def battery_entries():
    """``battery_1``, ``battery_2``."""
    scs = list(parity_battery.scenarios(BATTERY_T).values())
    for n_cars, what in ((1, "one-car"), (2, "two-car")):
        group = [sc for sc in scs if sc.n_cars == n_cars]
        phys, controls, r, params, teams = battery_group(group, "cuda")
        tracing.reset()
        for t in range(BATTERY_TICK):
            phys = A.arena_step(phys, controls[t], r, params, teams, 1, 0)
        launches = counter("kernel.launches")
        if launches != BATTERY_TICK:
            raise SystemExit(f"battery_{n_cars}: {launches} launches in "
                             f"{BATTERY_TICK} ticks")
        yield f"battery_{n_cars}", (
            f"soccar, full fidelity: the parity battery, {len(group)} "
            f"{what} scenarios as one arena axis, tick_skip 1, action delay "
            f"0, at tick {BATTERY_TICK}"), {
            "launches": launches,
            **measure(phys, controls[BATTERY_TICK], r, params, teams, 0, 1,
                      0, tolerance=ctick.DEFAULT_TOLERANCE)}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [{"name": f"arena_step ({what})", "label": label, **entry}
               for label, what, entry in (*main_path_entries(gen),
                                          *example_entries(gen),
                                          *battery_entries())]
    print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
