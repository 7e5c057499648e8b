"""Trainer: one training iteration is collect -> values -> GAE -> Welford
stats -> PPO update (the JAX package's ``Trainer._train_iteration_impl``;
GigaLearnCPP Learner.cpp:482-1056).

  collect: T x (policy sample -> env step -> store), bf16 inference
  values: one fp32 critic pass over the stored and the final observations
  GAE: a reverse loop over (T, N*P), each arena's terminal per player
  learn: PPO epochs over shuffled minibatches

Self-play (opponent versions, skill ratings) and checkpoints are not
ported: ``train_iteration`` raises with a self-play config, ``train`` with
a checkpoint folder.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from reinforcement_learning_torch.envs.env import EnvState, RocketLeagueEnv
from reinforcement_learning_torch.learn import gae as gaemod
from reinforcement_learning_torch.learn import welford
from reinforcement_learning_torch.learn.ppo import PPOConfig, PPOLearner


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """LearnerConfig (LearnerConfig.h:14-71), without the checkpoint
    cadence (checkpoints are not ported)."""
    ts_per_itr: int = 50_000
    standardize_returns: bool = True
    standardize_obs: bool = False
    min_obs_std: float = 0.1
    max_obs_mean_range: float = 3.0
    checkpoint_folder: str = ""
    random_seed: int = 123


@dataclasses.dataclass
class TrainState:
    """What changes across iterations, apart from the learner's parameters
    and optimiser states, which live in ``Trainer.learner``."""
    env_states: EnvState
    obs: torch.Tensor     # (N, P, D)
    masks: torch.Tensor   # (N, P, A) bool
    return_stat: welford.WelfordState = None
    obs_stat: welford.WelfordState = None
    total_timesteps: int = 0
    iterations: int = 0


class Trainer:
    def __init__(self, env: RocketLeagueEnv, ppo_config: PPOConfig,
                 config: TrainerConfig = TrainerConfig(),
                 learner: PPOLearner | None = None, selfplay=None):
        self.env = env
        self.config = config
        self.ppo_config = ppo_config
        self.selfplay = selfplay
        self.learner = learner or PPOLearner(
            env.obs_size, env.num_actions, ppo_config, device=env.device,
            seed=config.random_seed)
        n_players = env.config.num_envs * env.config.cars_per_arena
        # env steps per iteration so that collected player-steps >= target
        self.steps_per_itr = max(config.ts_per_itr // n_players, 1)
        self.players_per_step = n_players
        self.generator = torch.Generator(device=env.device).manual_seed(
            config.random_seed)

    def init(self, seed: int | None = None) -> TrainState:
        seed = self.config.random_seed if seed is None else seed
        env_states, obs, masks = self.env.reset(seed)
        dev = self.env.device
        return TrainState(
            env_states=env_states, obs=obs, masks=masks,
            return_stat=welford.WelfordState.make((), dev),
            obs_stat=welford.WelfordState.make((self.env.obs_size,), dev))

    def _maybe_std(self, state: TrainState, obs):
        cfg = self.config
        if cfg.standardize_obs:
            return welford.standardize_obs(state.obs_stat, obs,
                                           cfg.min_obs_std,
                                           cfg.max_obs_mean_range)
        return obs

    @torch.no_grad()
    def collect(self, state: TrainState, T: int | None = None):
        """Run ``T`` env steps (default ``steps_per_itr``).  Returns (state,
        traj) with traj keys as in the JAX package: obs, mask, action,
        old_logp, reward, terminal, final_obs, goal, touch (each stacked on
        a leading T axis) and reward_components (name -> (T,) means)."""
        T = self.steps_per_itr if T is None else T
        learner, env = self.learner, self.env
        env_states, obs, masks = state.env_states, state.obs, state.masks
        steps = []
        for _ in range(T):
            N, P, D = obs.shape
            obs_in = self._maybe_std(state, obs)
            actions, logp = learner.sample_actions(
                obs_in.reshape(N * P, D), masks.reshape(N * P, -1),
                generator=self.generator,
                deterministic=self.ppo_config.deterministic)
            act_grid = actions.reshape(N, P)
            env_states, out = env.step(env_states, act_grid)
            steps.append(dict(
                obs=obs_in, mask=masks, action=act_grid,
                old_logp=logp.reshape(N, P), reward=out.reward,
                terminal=out.terminal_type,
                final_obs=self._maybe_std(state, out.final_obs),
                goal=out.goal_scored, touch=out.ball_touched,
                reward_components={k: v.mean() for k, v in
                                   out.reward_components.items()}))
            obs, masks = out.obs, out.action_mask
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]
                if k != "reward_components"}
        traj["reward_components"] = {
            k: torch.stack([s["reward_components"][k] for s in steps])
            for k in steps[0]["reward_components"]}
        return dataclasses.replace(state, env_states=env_states, obs=obs,
                                   masks=masks), traj

    def learn(self, state: TrainState, traj: dict, perms=None):
        """The learning half of an iteration on a collected ``traj``
        (``_train_iteration_impl`` from the values pass on): ``prepare``,
        then the PPO update (``perms``: see ``PPOLearner.update``).
        Returns (state, metrics) with the iteration's metric keys; the
        metrics stay on the device."""
        state, data, metrics = self.prepare(state, traj)
        metrics = {**self.learner.update(data, generator=self.generator,
                                         perms=perms), **metrics}
        return state, metrics

    def prepare(self, state: TrainState, traj: dict):
        """Values, GAE and the Welford updates of a collected ``traj``.
        Returns (state with the new statistics and counters, the update's
        flat rows, the iteration's metrics other than the update's)."""
        cfg, learner = self.config, self.learner
        T, N, P = traj["action"].shape

        def flat(x):
            return x.reshape((T * N * P,) + tuple(x.shape[3:]))

        v_obs = learner.values(flat(traj["obs"]), half=False)
        v_final = learner.values(flat(traj["final_obs"]), half=False)

        terminal_tb = traj["terminal"].repeat_interleave(P, dim=-1)
        return_std = (state.return_stat.std if cfg.standardize_returns
                      else torch.ones((), device=v_obs.device))
        advs, target_values, returns, clip_portion = gaemod.compute_gae(
            traj["reward"].reshape(T, N * P), terminal_tb,
            v_obs.reshape(T, N * P), v_final.reshape(T, N * P),
            gamma=self.ppo_config.gae_gamma, lam=self.ppo_config.gae_lambda,
            return_std=return_std,
            reward_clip_range=self.ppo_config.reward_clip_range)

        return_stat = welford.update_batch(state.return_stat,
                                           returns.reshape(-1))
        obs_stat = state.obs_stat
        if cfg.standardize_obs:
            obs_stat = welford.update_batch(
                obs_stat, traj["obs"].reshape(-1, traj["obs"].shape[-1]))

        data = dict(obs=flat(traj["obs"]), mask=flat(traj["mask"]),
                    action=flat(traj["action"]),
                    old_logp=flat(traj["old_logp"]),
                    advantage=advs.reshape(-1),
                    target_value=target_values.reshape(-1))
        metrics = {}
        metrics["reward_mean"] = torch.mean(traj["reward"])
        metrics["goal_rate"] = torch.mean(traj["goal"].to(torch.float32))
        metrics["touch_rate"] = torch.mean(traj["touch"].to(torch.float32))
        metrics["episode_terminals"] = torch.sum(
            (traj["terminal"] > 0).to(torch.float32))
        metrics["return_std"] = return_stat.std
        metrics["reward_clip_portion"] = clip_portion
        metrics["value_mean"] = torch.mean(v_obs)
        for name, v in traj["reward_components"].items():
            metrics[f"reward/{name}"] = torch.mean(v)
        state = dataclasses.replace(
            state, return_stat=return_stat, obs_stat=obs_stat,
            total_timesteps=state.total_timesteps + T * N * P,
            iterations=state.iterations + 1)
        return state, data, metrics

    def train_iteration(self, state: TrainState):
        """One iteration: ``collect`` then ``learn``.  Returns (state,
        metrics); the metrics are tensors on the device."""
        if self.selfplay is not None:
            raise NotImplementedError("self-play is not ported")
        state, traj = self.collect(state)
        return self.learn(state, traj)

    def train(self, state: TrainState, num_iterations: int, log_fn=None,
              stop_fn=None) -> TrainState:
        """Run iterations.  ``log_fn(iteration, metrics)`` gets the metrics
        as floats with ``steps_per_second`` and ``iteration_time``, read
        after the device has finished; ``stop_fn()`` True ends training."""
        if self.config.checkpoint_folder:
            raise NotImplementedError("checkpoints are not ported")
        cuda = self.env.device.type == "cuda"
        for _ in range(num_iterations):
            t0 = time.perf_counter()
            state, metrics = self.train_iteration(state)
            if cuda:
                torch.cuda.synchronize(self.env.device)
            dt = time.perf_counter() - t0
            if log_fn is not None:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_second"] = (
                    self.steps_per_itr * self.players_per_step / dt)
                m["iteration_time"] = dt
                log_fn(state.iterations, m)
            if stop_fn is not None and stop_fn():
                break
        return state
