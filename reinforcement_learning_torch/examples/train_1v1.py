"""Example training program on the card: 1v1 soccar PPO (the JAX
package's ``examples/train_1v1.py``; ExampleMain.cpp:128-612).  The
configuration is code: the reward stack, the terminal conditions, the env
and the PPO settings are built explicitly, then trained.

Run on the card:
    python -m reinforcement_learning_torch.examples.train_1v1 [iterations] \\
        [--trace]

``--trace`` turns the port's tracer on: each iteration's metrics then hold
its timing block (``timing/<span>_ms``, ``count/<counter>``;
``Trainer.train``).
"""

from __future__ import annotations

import sys

from reinforcement_learning_torch.envs import rewards as R
from reinforcement_learning_torch.envs import terminals as T
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.envs.rewards import WeightedReward
from reinforcement_learning_torch.learn.ppo import PPOConfig
from reinforcement_learning_torch.learn.trainer import Trainer, TrainerConfig
from reinforcement_learning_torch.utils import tracing
from reinforcement_learning_torch.utils.report import Report


def make_env(num_envs: int = 256, device=None) -> RocketLeagueEnv:
    cfg = EnvConfig(num_envs=num_envs, team_size=1, tick_skip=8,
                    action_delay=7, no_touch_timeout=30.0,
                    max_episode_seconds=300.0, device=device)
    # the reward stack of the reference example's weights
    # (ExampleMain.cpp:132-177)
    reward_fns = [
        WeightedReward(R.velocity_player_to_ball_reward(), 0.4),
        WeightedReward(R.face_ball_reward(), 0.1),
        WeightedReward(R.touch_accel_reward(), 12.0),
        WeightedReward(R.strong_touch_reward(), 10.0),
        WeightedReward(R.zero_sum(R.velocity_ball_to_goal_reward(), 1.0),
                       4.0),
        WeightedReward(R.save_boost_reward(), 0.4),
        WeightedReward(R.zero_sum(R.goal_reward(), 1.0), 60.0),
        WeightedReward(R.demo_reward(), 8.0),
        WeightedReward(R.demoed_penalty(), 8.0),
    ]
    conds = [
        T.goal_score_condition(),
        T.no_touch_condition(cfg.no_touch_timeout, cfg.step_seconds),
        T.timeout_condition(cfg.max_episode_seconds, cfg.step_seconds),
    ]
    return RocketLeagueEnv(cfg, reward_fns=reward_fns, terminal_conds=conds)


def ppo_config() -> PPOConfig:
    return PPOConfig(
        policy_layers=(256, 256, 256),
        critic_layers=(256, 256, 256),
        shared_head_layers=(256,),
        batch_size=50_000, epochs=2,
        policy_lr=2e-4, critic_lr=2e-4,
        entropy_scale=0.018,
    )


def trainer_config() -> TrainerConfig:
    return TrainerConfig(ts_per_itr=50_000)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--trace" in argv:
        tracing.enable()
        argv = [a for a in argv if a != "--trace"]
    iterations = int(argv[0]) if argv else 50
    env = make_env()
    trainer = Trainer(env, ppo_config(), trainer_config())
    print("param counts:", trainer.learner.param_counts())
    print("steps/iteration:", trainer.steps_per_itr, "x",
          trainer.players_per_step, "players")

    state = trainer.init()

    def log(it, metrics):
        rep = Report(metrics)
        print(f"--- iteration {it} "
              f"({metrics['steps_per_second']:,.0f} steps/s) ---")
        print(rep.display())

    trainer.train(state, iterations, log_fn=log)


if __name__ == "__main__":
    main()
