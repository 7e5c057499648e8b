"""Trainer, collection half: policy sample -> env step -> store, T times
(the rollout of the JAX package's ``Trainer._train_iteration_impl``).

Values, GAE and the PPO update are not ported yet; neither are self-play
and observation standardisation (off by default there).
"""

from __future__ import annotations

import dataclasses

import torch

from reinforcement_learning_torch.envs.env import EnvState, RocketLeagueEnv
from reinforcement_learning_torch.learn.ppo import PPOConfig, PPOLearner


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """LearnerConfig (LearnerConfig.h:14-71), the fields collection reads."""
    ts_per_itr: int = 50_000
    random_seed: int = 123


@dataclasses.dataclass
class TrainState:
    env_states: EnvState
    obs: torch.Tensor     # (N, P, D)
    masks: torch.Tensor   # (N, P, A) bool


class Trainer:
    def __init__(self, env: RocketLeagueEnv, ppo_config: PPOConfig,
                 config: TrainerConfig = TrainerConfig(),
                 learner: PPOLearner | None = None):
        self.env = env
        self.config = config
        self.ppo_config = ppo_config
        self.learner = learner or PPOLearner(
            env.obs_size, env.num_actions, ppo_config, device=env.device,
            seed=config.random_seed)
        n_players = env.config.num_envs * env.config.cars_per_arena
        # env steps per iteration so that collected player-steps >= target
        self.steps_per_itr = max(config.ts_per_itr // n_players, 1)
        self.generator = torch.Generator(device=env.device).manual_seed(
            config.random_seed)

    def init(self, seed: int | None = None) -> TrainState:
        seed = self.config.random_seed if seed is None else seed
        env_states, obs, masks = self.env.reset(seed)
        return TrainState(env_states=env_states, obs=obs, masks=masks)

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
            actions, logp = learner.sample_actions(
                obs.reshape(N * P, D), masks.reshape(N * P, -1),
                generator=self.generator,
                deterministic=self.ppo_config.deterministic)
            act_grid = actions.reshape(N, P)
            env_states, out = env.step(env_states, act_grid)
            steps.append(dict(
                obs=obs, mask=masks, action=act_grid,
                old_logp=logp.reshape(N, P), reward=out.reward,
                terminal=out.terminal_type, final_obs=out.final_obs,
                goal=out.goal_scored, touch=out.ball_touched,
                reward_components={k: v.mean() for k, v in
                                   out.reward_components.items()}))
            obs, masks = out.obs, out.action_mask
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]
                if k != "reward_components"}
        traj["reward_components"] = {
            k: torch.stack([s["reward_components"][k] for s in steps])
            for k in steps[0]["reward_components"]}
        return TrainState(env_states=env_states, obs=obs, masks=masks), traj
