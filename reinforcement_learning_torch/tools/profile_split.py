"""Timing split: rollout-only vs PPO-update-only vs raw physics step (the
twin of the JAX package's ``tools/profile_split.py``).

Not a test -- a perf triage tool.  Run on the card:
    python -m reinforcement_learning_torch.tools.profile_split [num_envs]
        [--device=cpu]

The main path's configuration: ``num_envs`` (default 1024) x 2v2 soccar
at full fidelity, the 384-wide trio inferring in bf16, batch 50k, 2
epochs, ~100k player-steps an iteration.  Six regions, each run once and
then ``ITERS`` times, ending in ``torch.cuda.synchronize()``: env steps
with random actions, the rollout (policy sample + env step), inference
only, the PPO update on synthetic data of the buffer's shape, one critic
value pass over it, and the full ``Trainer.train_iteration``.  The JAX
tool's ``lax.scan``s are Python loops over ``env.step`` and
``sample_actions`` here.
"""
from __future__ import annotations

import sys
import time

PPO = dict(policy_layers=(384, 384, 384), critic_layers=(384, 384, 384),
           shared_head_layers=(384, 384), batch_size=50_000, epochs=2,
           half_precision=True)
TS_PER_ITR = 100_000
ITERS, FULL_ITERS = 10, 5     # timed calls of each region after the first


def make_env(N: int, device=None):
    """The main path's env: ``N`` x 2v2 soccar at full fidelity."""
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    return RocketLeagueEnv(EnvConfig(num_envs=N, team_size=2,
                                     device=device))


def profile(N: int = 1024, device=None) -> dict:
    """Prints the six timings and the closing line; returns name -> s per
    call."""
    import torch

    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)

    env = make_env(N, device)
    trainer = Trainer(env, PPOConfig(**PPO),
                      TrainerConfig(ts_per_itr=TS_PER_ITR))
    T = trainer.steps_per_itr
    P = env.config.cars_per_arena
    state = trainer.init(0)
    learner = trainer.learner
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bench(name, fn, *args, iters=ITERS):
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        dt = (time.perf_counter() - t0) / iters
        steps = T * N * P
        print(f"{name:28s} {dt*1e3:9.2f} ms/iter   "
              f"({steps/dt:,.0f} steps/s at T={T})", flush=True)
        return dt

    # 1. raw physics+env step, no policy: T env steps with random actions
    def env_only(env_states):
        rews = []
        for _ in range(T):
            act = torch.randint(0, env.num_actions, (N, P), generator=gen,
                                device=dev)
            env_states, out = env.step(env_states, act)
            rews.append(out.reward)
        return torch.stack(rews)

    # 2. rollout with policy sampling (the collect loop), no learn
    def rollout_only(env_states, obs, masks):
        ys = []
        for _ in range(T):
            actions, logp = learner.sample_actions(
                obs.reshape(-1, obs.shape[-1]),
                masks.reshape(-1, masks.shape[-1]), generator=gen)
            env_states, out = env.step(env_states, actions.reshape(N, P))
            obs, masks = out.obs, out.action_mask
            ys.append((out.reward, logp))
        return ys

    # 3. inference only: T policy-sample calls on the resident obs
    def infer_only(obs, masks):
        acc = torch.zeros((), device=dev)
        for _ in range(T):
            _, logp = learner.sample_actions(
                obs.reshape(-1, obs.shape[-1]),
                masks.reshape(-1, masks.shape[-1]), generator=gen)
            acc = acc + logp.sum()
        return acc

    # 4. PPO update only on synthetic data of the same shape
    g1 = torch.Generator(device=dev).manual_seed(1)
    B = T * N * P
    obs_dim = state.obs.shape[-1]
    A = env.num_actions
    data = dict(
        obs=torch.randn(B, obs_dim, generator=g1, device=dev),
        mask=torch.ones(B, A, dtype=torch.bool, device=dev),
        action=torch.randint(0, A, (B,), generator=g1, device=dev),
        old_logp=torch.full((B,), -4.5, device=dev),
        advantage=torch.randn(B, generator=g1, device=dev),
        target_value=torch.randn(B, generator=g1, device=dev),
    )

    def update(d):
        return learner.update(d, generator=gen)

    # 5. critic value pass on the full buffer (done twice in
    # train_iteration)
    def values(o):
        return learner.values(o, half=False)

    print(f"# N={N} T={T} players={N*P} buffer={B}")
    out = {}
    out["env"] = bench("env-only (random actions)", env_only,
                       state.env_states)
    out["rollout"] = bench("rollout (policy+env)", rollout_only,
                           state.env_states, state.obs, state.masks)
    out["inference"] = bench("inference only (T fwd)", infer_only,
                             state.obs, state.masks)
    out["update"] = bench("ppo update (2 epochs)", update, data)
    out["values"] = bench("critic value pass (x1)", values, data["obs"])
    out["full"] = bench("full train_iteration",
                        lambda s: trainer.train_iteration(s), state,
                        iters=FULL_ITERS)
    print(f"# rollout+update+2*values = "
          f"{(out['rollout'] + out['update'] + 2 * out['values'])*1e3:.1f} "
          f"ms vs full {out['full']*1e3:.1f} ms")
    return out


if __name__ == "__main__":
    from reinforcement_learning_torch.tools.parity_battery import option
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    profile(int(args[0]) if args else 1024, device=option("device"))
