"""Weak-scaling harness of the data-parallel trainer (the twin of the JAX
package's ``tools/bench_scaling.py``).

Envs per rank fixed, the env axis sharded over 1, 2, 4, 8 ranks
(``parallel/mesh.py``), each count a set of child processes started with
the variables ``torchrun`` sets, with a timeout.  By default one rank per
card over NCCL; with ``--device cpu`` the ranks are gloo processes of one
thread each (the JAX harness's virtual CPU devices).  The same 64-wide
trio, plane arena and 16 rows per arena as the JAX harness.

Usage:
  python -m reinforcement_learning_torch.tools.bench_scaling          # 1,2,4,8
  python -m reinforcement_learning_torch.tools.bench_scaling --devices 1 2
  python -m reinforcement_learning_torch.tools.bench_scaling --device cpu
  torchrun --nproc-per-node N -m reinforcement_learning_torch.tools.\\
bench_scaling --child N                    # one measurement

Writes ``build/scaling_torch.json`` (``--out``): per count steps/s,
per-rank steps/s and efficiency against the 1-rank run, on which device.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "scaling_torch.json"
WIDTH = 64              # the trio's layers, as the JAX harness's
ROWS_PER_ARENA = 16     # player-steps per arena and iteration: 8 env steps


def run_child(world: int, num_envs: int, iters: int,
              device: str) -> dict | None:
    """One measurement on this rank (the process group from torchrun's
    variables); rank 0 returns it, the others None."""
    import torch

    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    from reinforcement_learning_torch.parallel import mesh as meshmod
    from reinforcement_learning_torch.physics import step as stepmod

    if not meshmod.initialize_distributed(device=device):
        raise RuntimeError("--child runs under torchrun's variables")
    mesh = meshmod.make_mesh(world)
    # the plane arena, as the JAX harness's: the partitioning and the
    # collectives under test are those of every arena
    env = RocketLeagueEnv(EnvConfig(
        num_envs=num_envs, team_size=1, device=device,
        arena=stepmod.ArenaParams(num_cars=2, use_mesh=False)))
    rows = num_envs * ROWS_PER_ARENA
    ppo_cfg = PPOConfig(policy_layers=(WIDTH, WIDTH),
                        critic_layers=(WIDTH, WIDTH),
                        shared_head_layers=(WIDTH,), batch_size=rows,
                        epochs=1, half_precision=False)
    trainer = Trainer(env, ppo_cfg, TrainerConfig(ts_per_itr=rows))
    state = meshmod.shard_train_state(trainer, trainer.init(0), mesh)

    def sync():
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)
    state, _ = trainer.train_iteration(state)        # warm-up
    sync()
    steps_per_itr = trainer.steps_per_itr * trainer.players_per_step
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = trainer.train_iteration(state)
    sync()
    dt = time.perf_counter() - t0
    rank = trainer.env.shard.rank
    torch.distributed.destroy_process_group()
    if rank:
        return None
    return {"n_devices": world, "num_envs": num_envs,
            "steps": steps_per_itr * iters, "seconds": dt,
            "steps_per_sec": steps_per_itr * iters / dt}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, args) -> dict:
    """``world`` child processes with torchrun's variables; rank 0's
    result.  Kills them all and raises if one fails or they outlast
    ``args.timeout``."""
    port = _free_port()
    cmd = [sys.executable, "-m", "reinforcement_learning_torch.tools."
           "bench_scaling", "--child", str(world), "--envs-per-device",
           str(args.envs_per_device), "--iters", str(args.iters),
           "--device", args.device]
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    deadline = time.monotonic() + args.timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    line = [ln for ln in outs[0][0].splitlines()
            if ln.startswith("CHILD_RESULT ")]
    if any(p.returncode for p in procs) or not line:
        for rank, (out, err) in enumerate(outs):
            print(f"rank {rank}: {out[-2000:]}{err[-2000:]}")
        raise RuntimeError(f"the {world}-rank run failed: exit codes "
                           f"{[p.returncode for p in procs]}")
    return json.loads(line[0][len("CHILD_RESULT "):])


def _device_name(device: str) -> tuple[str, int]:
    """(the device's name, with each card's name and power limit as
    nvidia-smi gives them; how many there are)."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA card")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return "; ".join(smi), torch.cuda.device_count()
    return "cpu", os.cpu_count()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--envs-per-device", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds for each rank count")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()

    if args.child is not None:
        import torch
        torch.set_num_threads(1)
        res = run_child(args.child, args.envs_per_device * args.child,
                        args.iters, args.device)
        if res is not None:
            print("CHILD_RESULT " + json.dumps(res), flush=True)
        return

    name, count = _device_name(args.device)
    results = []
    for n in args.devices:
        if args.device == "cuda" and n > count:
            print(f"--- {n} ranks: skipped, {count} card(s) (NCCL takes "
                  "one rank per card)", flush=True)
            continue
        print(f"--- {n} rank(s) on {args.device}", flush=True)
        results.append(launch(n, args))
        print(f"    {results[-1]['steps_per_sec']:,.0f} steps/s", flush=True)

    base_per_dev = results[0]["steps_per_sec"] / results[0]["n_devices"]
    for r in results:
        r["steps_per_sec_per_device"] = r["steps_per_sec"] / r["n_devices"]
        r["efficiency_vs_1dev"] = r["steps_per_sec_per_device"] / base_per_dev
        r["contended"] = r["n_devices"] > count
    unit = "cores" if args.device == "cpu" else "cards"
    out = {"harness": f"torch.distributed, {args.device} "
                      f"({'gloo' if args.device == 'cpu' else 'nccl'})",
           "note": ("weak scaling: envs per rank fixed; efficiency = "
                    "per-rank throughput vs the 1-rank run.  This host has "
                    f"{count} {unit}; a row with \"contended\" true runs "
                    f"more ranks (of one thread each on the CPU) than "
                    f"{unit}, so it measures contention for them, not "
                    "scaling."),
           "device": name, "host_cpus": os.cpu_count(), "results": results}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
