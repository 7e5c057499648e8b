#!/usr/bin/env python3
"""Training throughput of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 bench_torch.py [num_envs] [iters]

The twin of bench.py: the same configuration (1024 arenas x 2v2 soccar at
full fidelity, tick_skip 8 / action_delay 7, AdvancedObs 167,
DefaultAction 90, shared 384x2 + policy 384x3 + critic 384x3 MLPs
inferring in bf16, about 100k player-steps per iteration, minibatch 50k,
2 epochs), one warm-up iteration, then ``iters`` timed iterations of
``Trainer.train_iteration`` with one synchronisation at the end.  Prints
the card's name and power limit on stderr and one JSON line on stdout:
``{"metric", "value", "unit", "warmup_s"}``.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BENCH_PPO = dict(policy_layers=(384, 384, 384), critic_layers=(384, 384, 384),
                 shared_head_layers=(384, 384), batch_size=50_000, epochs=2,
                 half_precision=True)
TS_PER_ITR = 100_000


def bench_trainer(num_envs: int = 1024, game_mode: str = "soccar",
                  seed: int = 0):
    """The benchmark's env and trainer on the card."""
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)
    env = RocketLeagueEnv(EnvConfig(num_envs=num_envs, team_size=2,
                                    game_mode=game_mode, device="cuda"))
    return Trainer(env, PPOConfig(**BENCH_PPO),
                   TrainerConfig(ts_per_itr=TS_PER_ITR, random_seed=seed))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def main():
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA card", file=sys.stderr)
        return 1
    num_envs = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    trainer = bench_trainer(num_envs)
    n_players = trainer.players_per_step
    print(f"# {card()}; players={n_players} "
          f"steps/itr={trainer.steps_per_itr} "
          f"params={trainer.learner.param_counts()}", file=sys.stderr)
    state = trainer.init()

    t0 = time.perf_counter()
    state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    print(f"# warm-up (kernel build if needed + one iteration): "
          f"{warmup_s:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.train_iteration(state)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    steps = trainer.steps_per_itr * n_players * iters
    print(f"# {iters} iterations in {total:.2f} s "
          f"({total / iters:.3f} s/iter)", file=sys.stderr)
    print(json.dumps({
        "metric": "env-steps/s (2v2 soccar, full PPO loop, 1 GPU)",
        "value": round(steps / total, 1),
        "unit": "steps/s",
        "warmup_s": round(warmup_s, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
