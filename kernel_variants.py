#!/usr/bin/env python3
"""Time builds of the arena-step kernel against each other on one card.

    python3 kernel_variants.py [LABEL=CSRC_DIR[+MACRO...] ...]
    python3 kernel_variants.py --stages

Each variant is the kernel source in CSRC_DIR (a folder holding
arena_step.cu and the headers it includes), compiled by nvcc for sm_90a
with the repository's flags and ``-DMACRO`` for each ``+MACRO``, as one
translation unit holding every car count, all variants at once.  Without
arguments the variants are this checkout's kernel (``shared``) and the
same source with the full-fidelity branches compiled out (``plane_only``,
``-DARENA_STEP_PLANE_ONLY``).

Every variant steps the same inputs: 1024 arenas x 2v2 after kickoff and 6
env steps of random controls (stepped by the first variant), once on the
plane arena and once at full fidelity (the default ``ArenaParams``), in
soccar.  A variant whose ``Params`` struct is shorter than today's gets
its leading part: a kernel from before the game modes (its struct ends
with the facet tables) runs both, one from before full fidelity the plane
arena only, as does a plane-only build.  Times come from CUDA events, 10
launches per sample, the variants taken in the order A B .. B A, twice.
Prints each variant's ptxas line for the 4-car kernel, its largest
deviation from the first variant's output, its times, and the card's name
and power limit; the last line is one JSON object of the medians.

With ``--stages`` it builds this checkout's kernel with its stage clocks
(``-DARENA_STEP_STAGE_CLOCKS``: each arena's lane 0 adds the cycles of
every stage of a tick, meetings included) and prints the cycles per
arena-tick of each stage over 10 env steps, on the plane and
full-fidelity inputs above and on a played full-fidelity input (48 env
steps of random controls after kickoff).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
E, CARS, SEED = 1024, 4, 0


def parse(args):
    here = os.path.join(ROOT, "reinforcement_learning_torch", "csrc")
    if not args:
        args = [f"shared={here}", f"plane_only={here}+ARENA_STEP_PLANE_ONLY"]
    out = []
    for a in args:
        label, spec = a.split("=", 1)
        src, *macros = spec.split("+")
        out.append((label, os.path.abspath(src), tuple(macros)))
    return out


def build_all(variants, build_dir):
    """One nvcc per variant, all started together.  Returns {label: (path
    of the .so, ptxas lines of the 4-car kernel)}."""
    from reinforcement_learning_torch.ops import arena_step as A
    procs = {}
    for label, src, macros in variants:
        so = os.path.join(build_dir, f"{label}.so")
        cmd = [A.nvcc(), *A.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
               *(f"-D{m}" for m in macros), "-o", so,
               os.path.join(src, "arena_step.cu")]
        procs[label] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lines = log.splitlines()
        four = [i for i, ln in enumerate(lines)
                if "entry function" in ln and "ILi4E" in ln]
        info = [ln.split(":", 1)[-1].strip()
                for ln in lines[four[0] + 2:four[0] + 4]] if four else []
        built[label] = (so, info)
    return built


def inputs(params, lib, teams, dev, gen, steps=6):
    """(state, controls, respawn draws) after kickoff and ``steps`` env
    steps of random controls, stepped by ``lib``."""
    import torch
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.ops import arena_step as A
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, arena=params,
                                    device="cuda"))
    phys = env.reset(SEED)[0].phys
    stream = torch.cuda.current_stream().cuda_stream

    def draw():
        analog = torch.rand(E, CARS, 5, generator=gen, device=dev) * 2 - 1
        buttons = (torch.rand(E, CARS, 3, generator=gen, device=dev)
                   > 0.5).float()
        return (torch.cat([analog, buttons], -1),
                torch.randint(0, 4, (E, CARS), generator=gen, device=dev,
                              dtype=torch.int32))
    for _ in range(steps):
        phys = A._launch(lib, phys, *draw(), params, teams, 8, 7, stream)
    return (phys, *draw())


STAGES = ("controls, demo respawn", "wheel rays and friction",
          "facet items", "retention", "per car: state machines to world "
          "step; pad timers", "ball pre-tick; each car vs the world",
          "car-ball", "ball vs the world; car pairs", "integration",
          "pad pickup", "boost gain, goal")


def stage_clocks(build_dir, dev, teams, gen):
    """Cycles per arena-tick of each stage of the stage-clock build."""
    import ctypes
    import torch
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.physics.step import ArenaParams
    here = os.path.join(ROOT, "reinforcement_learning_torch", "csrc")
    so, info = build_all([("stages", here, ("ARENA_STEP_STAGE_CLOCKS",))],
                         build_dir)["stages"]
    print(f"[stages] 4-car kernel: {'; '.join(info)}")
    lib = A._library(so)
    lib.arena_step_stage_cycles.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * len(STAGES))()
    full = ArenaParams(num_cars=CARS)
    stream = torch.cuda.current_stream().cuda_stream
    for cfg, params, steps in (
            ("plane", ArenaParams(num_cars=CARS, use_mesh=False,
                                  dynamic_wheel_rays=False), 6),
            ("full", full, 6), ("full_played", full, 48)):
        phys, ctl, r = inputs(params, lib, teams, dev, gen, steps)
        A._launch(lib, phys, ctl, r, params, teams, 8, 7, stream)
        torch.cuda.synchronize()
        if lib.arena_step_stage_cycles(cycles):
            raise RuntimeError("reading the stage clocks failed")
        for _ in range(10):
            A._launch(lib, phys, ctl, r, params, teams, 8, 7, stream)
        torch.cuda.synchronize()
        if lib.arena_step_stage_cycles(cycles):
            raise RuntimeError("reading the stage clocks failed")
        per = [c / (10 * E * 8) for c in cycles]
        print(f"[stages] {cfg} ({steps} env steps after kickoff), cycles "
              f"per arena-tick, total {sum(per):.0f}:")
        for name, c in zip(STAGES, per):
            print(f"[stages]   {name:48s} {c:9.0f} "
                  f"{100 * c / sum(per):5.1f}%")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.physics.step import ArenaParams
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    teams = (0, 0, 1, 1)
    os.makedirs(A.BUILD_DIR, exist_ok=True)
    if argv == ["--stages"]:
        with tempfile.TemporaryDirectory(dir=A.BUILD_DIR) as build_dir:
            stage_clocks(build_dir, dev, teams,
                         torch.Generator(device=dev).manual_seed(SEED))
        return 0
    variants = parse(argv)
    with tempfile.TemporaryDirectory(dir=A.BUILD_DIR) as build_dir:
        t0 = time.perf_counter()
        built = build_all(variants, build_dir)
        print(f"[build] {len(built)} variants in "
              f"{time.perf_counter() - t0:.1f} s")
        libs = {label: A._library(so) for label, (so, _) in built.items()}
        for label, (_, info) in built.items():
            print(f"[{label}] 4-car kernel: {'; '.join(info)}")

        configs = {"plane": ArenaParams(num_cars=CARS, use_mesh=False,
                                        dynamic_wheel_rays=False),
                   "full": ArenaParams(num_cars=CARS)}
        gen = torch.Generator(device=dev).manual_seed(SEED)
        first = variants[0][0]
        result = {}
        for cfg, params in configs.items():
            phys, ctl, r = inputs(params, libs[first], teams, dev, gen)
            f, i, u = A._pack(phys)
            ctl_k = ctl.permute(2, 1, 0).contiguous()
            r_k = r.transpose(0, 1).contiguous()
            prm = A.pack_params(params, teams)
            # bytes up to the end of the full-fidelity tail
            full_bytes = prm.nbytes - 4 * len(A._pack_game_mode(
                A._consts(params, teams)))
            stream = torch.cuda.current_stream().cuda_stream
            runs = {}
            for label, src, macros in variants:
                lib = libs[label]
                n = lib.arena_step_params_bytes()
                if n < full_bytes and cfg != "plane":
                    continue
                if "ARENA_STEP_PLANE_ONLY" in macros and cfg != "plane":
                    continue
                head = prm[:n // 4].copy()
                outs = [torch.empty_like(x) for x in (f, i, u)]

                def launch(lib=lib, head=head, outs=outs, label=label):
                    err = lib.arena_step_launch(
                        head.ctypes.data, head.nbytes, f.data_ptr(),
                        i.data_ptr(), u.data_ptr(), outs[0].data_ptr(),
                        outs[1].data_ptr(), outs[2].data_ptr(),
                        ctl_k.data_ptr(), r_k.data_ptr(), E, CARS, 8, 7,
                        stream)
                    if err:
                        raise RuntimeError(f"{label}: launch error {err}")
                launch()
                torch.cuda.synchronize()
                runs[label] = (launch, outs)
            ref = runs[first][1]
            for label, (_, outs) in runs.items():
                dev_f = float((outs[0] - ref[0]).abs().max())
                same_iu = (torch.equal(outs[1], ref[1])
                           and torch.equal(outs[2], ref[2]))
                print(f"[{cfg}] {label} vs {first}: max |float diff| "
                      f"{dev_f:.3g}, ints and bools equal: {same_iu}")
            order = list(runs) + list(reversed(runs))
            samples = {label: [] for label in runs}
            for label in order + order:
                launch = runs[label][0]
                for _ in range(2):
                    launch()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(10):
                    launch()
                stop.record()
                torch.cuda.synchronize()
                samples[label].append(start.elapsed_time(stop) / 10)
            for label, ms in samples.items():
                print(f"[{cfg}] {label}: ms per env step "
                      f"{[round(x, 4) for x in ms]}, median "
                      f"{statistics.median(ms):.4f} (E={E}, C={CARS})")
                result.setdefault(cfg, {})[label] = statistics.median(ms)
    print(json.dumps({"card": smi, "median_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
