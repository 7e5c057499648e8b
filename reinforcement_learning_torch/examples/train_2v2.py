"""The canonical training program on the card: 2v2 soccar PPO with
self-play (ExampleMain.cpp:289-612; the JAX package's
``examples/train_2v2.py``), knob for knob:

  * the full reward stack with KickoffProximityReward2v2Enhanced, zero-sum
    wrappers and the losing-team penalty (ExampleMain.cpp:132-177)
  * NoTouchCondition(8 s) + ScoreLimitCondition(3) + the 300 s timeout
    (ExampleMain.cpp:179-189)
  * AdvancedObs / DefaultAction / KickoffState (ExampleMain.cpp:216-220)
  * the per-step user metrics callback (ExampleMain.cpp:232-254)
  * ``--render`` (one arena streamed to RocketSimVis) and ``--scale=``
    model scaling (ExampleMain.cpp:300-330, 436-522)
  * tick skip 8 / action delay 7, 512 games, seed 123, 100k steps per
    iteration, batch 100k, 2 epochs, entropy 0.035 on the normalised
    entropy, gamma 0.99, learning rate 2.5e-4, AdamW, LayerNorm, leaky
    ReLU, shared 512x2, policy 512x3 and critic 512x3 before scaling
    (ExampleMain.cpp:352-584)
  * self-play: a version every 25M steps, 32 kept, an old opponent with
    chance 0.15, ELO skill matches every 16 iterations on 16 arenas
  * wandb metrics (or a JSONL file beside the checkpoints), a checkpoint
    every 10M steps with auto-resume, 'Q' to save and quit
    (Learner.cpp:145-161, 224-298, 1011-1048)
  * ``--trace``: the port's tracer on, and each iteration's timing block
    (``timing/<span>_ms`` of every span, ``count/<counter>``;
    ``Trainer.train``) among the metrics, as the reference's Report prints
    its timings (Learner.cpp:646-994)

The JAX program's ``--backend=`` has no counterpart: the port steps its
physics with one route per device, the CUDA kernel on the card and its
plain PyTorch version on the CPU.

Run on the card:
    python -m reinforcement_learning_torch.examples.train_2v2 \\
        [iterations] [--render] [--scale=1.5] [--trace]
"""

from __future__ import annotations

import os
import sys

import torch

from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.envs import rewards as R
from reinforcement_learning_torch.envs import terminals as T
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.envs.kickoff_reward import (
    kickoff_proximity_reward_2v2)
from reinforcement_learning_torch.envs.rewards import WeightedReward
from reinforcement_learning_torch.learn import selfplay as sp
from reinforcement_learning_torch.learn.ppo import PPOConfig
from reinforcement_learning_torch.learn.trainer import Trainer, TrainerConfig
from reinforcement_learning_torch.utils import tracing
from reinforcement_learning_torch.utils.keypress import KeyPressDetector
from reinforcement_learning_torch.utils.metrics import MetricSender
from reinforcement_learning_torch.utils.report import Report

NUM_GAMES = 512
TS_PER_ITR = 100_000
CHECKPOINT_FOLDER = "checkpoints/train_2v2"


# --- env factory (EnvCreateFunc, ExampleMain.cpp:128-226) ------------------

def make_env(num_envs: int, render_mode: bool = False,
             device=None) -> RocketLeagueEnv:
    cfg = EnvConfig(
        num_envs=1 if render_mode else num_envs,
        team_size=2,                      # playersPerTeam = 2
        tick_skip=8, action_delay=7,      # actionDelay = tickSkip - 1
        no_touch_timeout=8.0,
        max_episode_seconds=300.0,        # cfg.ppo.maxEpisodeDuration
        device=device,
    )
    rewards = [
        # Movement
        WeightedReward(R.air_reward(), 0.25),
        WeightedReward(R.wavedash_reward(), 0.12),
        WeightedReward(kickoff_proximity_reward_2v2(), 5.0),
        # Player-ball
        WeightedReward(R.velocity_player_to_ball_reward(), 4.0),
        WeightedReward(R.strong_touch_reward(20, 120), 60.0),
        WeightedReward(R.touch_accel_reward(), 6.0),
        # Ball-goal
        WeightedReward(R.zero_sum(R.velocity_ball_to_goal_reward(), 1.0),
                       8.0),
        # Boost
        WeightedReward(R.pickup_boost_reward(), 0.1),
        WeightedReward(R.save_boost_reward(), 0.010),
        # Game events
        WeightedReward(R.zero_sum(R.bump_reward(), 0.5), 20.0),
        WeightedReward(R.zero_sum(R.demo_reward(), 0.5), 80.0),
        WeightedReward(R.zero_sum(R.goal_reward(), 1.0), 150.0),
        # Losing-team catch-up penalty
        WeightedReward(R.losing_penalty_reward(0.02), 1.0),
    ]
    conds = [
        T.no_touch_condition(8.0, cfg.step_seconds),
        T.score_limit_condition(3),
        T.timeout_condition(cfg.max_episode_seconds, cfg.step_seconds),
    ]
    return RocketLeagueEnv(cfg, reward_fns=rewards, terminal_conds=conds)


# --- per-step user metrics (StepCallback, ExampleMain.cpp:232-254) ---------

def step_metrics(env_states, out):
    cars = env_states.phys.arena.cars
    ball = env_states.phys.arena.ball
    speed = m.norm(cars.vel)
    to_ball = m.normalize(ball.pos[:, None, :] - cars.pos)
    toward = torch.clamp(torch.sum(cars.vel * to_ball, dim=-1), min=0.0)
    return {
        "Player/In Air Ratio": (~cars.is_on_ground).to(torch.float32),
        "Player/Ball Touch Ratio": out.ball_touched.to(torch.float32),
        "Player/Demoed Ratio": cars.is_demoed.to(torch.float32),
        "Player/Speed": speed,
        "Player/Speed Towards Ball": toward,
        "Player/Boost": cars.boost,
        "Player/Touch Height": (
            ball.pos[:, None, 2].expand(out.ball_touched.shape),
            out.ball_touched),
        "Game/Goal Speed": (m.norm(ball.vel), out.goal_scored),
    }


# --- model scaling (ExampleMain.cpp:436-522) --------------------------------

def scaled_sizes(base: tuple, scale: float) -> tuple:
    out = []
    for v in base:
        nv = max(1, round(v * scale))
        if nv % 8:
            nv += 8 - nv % 8       # multiples of 8 for the matrix units
        out.append(nv)
    return tuple(out)


def auto_scale(num_games: int) -> float:
    """1.4 on one card (1.8 from two, 2.2 from four), +0.1 from 512 games;
    on the CPU by core count."""
    if torch.cuda.is_available():
        scale = 1.4                # single accelerator baseline
        if torch.cuda.device_count() >= 2:
            scale = 1.8
        if torch.cuda.device_count() >= 4:
            scale = 2.2
        if num_games >= 512:
            scale += 0.1
    else:
        hc = os.cpu_count() or 4
        scale = 1.25 if hc >= 16 else (1.15 if hc >= 8 else 1.05)
    return min(max(scale, 1.0), 3.0)


# --- the configuration (ExampleMain.cpp:352-584) ----------------------------

def ppo_config(scale: float) -> PPOConfig:
    return PPOConfig(
        ts_per_itr=TS_PER_ITR,
        batch_size=TS_PER_ITR,
        mini_batch_size=50_000,
        max_episode_duration=300.0,
        epochs=2,
        entropy_scale=0.035,
        gae_gamma=0.99,
        policy_lr=2.5e-4, critic_lr=2.5e-4,
        shared_head_layers=scaled_sizes((512, 512), scale),
        policy_layers=scaled_sizes((512, 512, 512), scale),
        critic_layers=scaled_sizes((512, 512, 512), scale),
        optim="adamw",
        activation="leaky_relu",
        layer_norm=True,
        half_precision=True,
    )


def trainer_config(checkpoint_folder: str = CHECKPOINT_FOLDER
                   ) -> TrainerConfig:
    return TrainerConfig(
        ts_per_itr=TS_PER_ITR,
        random_seed=123,
        checkpoint_folder=checkpoint_folder,
        ts_per_save=10_000_000,
        checkpoints_to_keep=8,
    )


def selfplay_config() -> sp.SelfPlayConfig:
    return sp.SelfPlayConfig(
        save_versions=True, ts_per_version=25_000_000, max_versions=32,
        train_against_old=True, train_against_old_chance=0.15,
        skill=sp.SkillTrackerConfig(enabled=True, num_arenas=16,
                                    update_interval=16, rating_inc=5.0))


# --- render mode (Learner.cpp:799-802 + RenderSender) -----------------------

def run_render(env: RocketLeagueEnv, trainer: Trainer, state=None,
               time_scale: float = 1.0, steps: int | None = None):
    """Step the env with the trainer's policy and stream arena 0 to
    RocketSimVis, forever or for ``steps`` steps."""
    from reinforcement_learning_torch.utils.render import (RenderSender,
                                                           arena_on_host)

    sender = RenderSender(time_scale=time_scale,
                          step_seconds=env.config.step_seconds)
    learner = trainer.learner
    env_states, obs, masks = env.reset(0)
    gen = torch.Generator(device=env.device).manual_seed(1)
    print("render mode: streaming to RocketSimVis (UDP 127.0.0.1:9273)")
    n = 0
    while steps is None or n < steps:
        actions, _ = learner.sample_actions(
            obs.reshape(-1, obs.shape[-1]), masks.reshape(-1, masks.shape[-1]),
            generator=gen)
        env_states, out = env.step(env_states, actions.reshape(obs.shape[:-1]))
        obs, masks = out.obs, out.action_mask
        sender.send(arena_on_host(env_states.phys.arena), env.teams_np,
                    ball_touched=out.ball_touched[0])
        n += 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    iterations = 1_000_000
    render_mode = False
    scale = -1.0
    for arg in argv:
        if arg == "--render":
            render_mode = True
        elif arg == "--trace":
            tracing.enable()
        elif arg.startswith("--scale="):
            scale = float(arg.split("=", 1)[1])
        elif arg.isdigit():
            iterations = int(arg)

    env = make_env(NUM_GAMES, render_mode)
    if scale <= 0:
        scale = auto_scale(NUM_GAMES)
    ppo = ppo_config(scale)
    print(f"model scale factor: {scale}")
    print(f"shared head sizes: {list(ppo.shared_head_layers)}")
    print(f"policy sizes: {list(ppo.policy_layers)}")
    print(f"critic sizes: {list(ppo.critic_layers)}")

    cfg = trainer_config()
    trainer = Trainer(env, ppo, cfg, selfplay=selfplay_config(),
                      step_metrics_fn=step_metrics)
    print("param counts:", trainer.learner.param_counts())
    state = trainer.init_or_resume()
    if state.iterations:
        print(f"resumed from iteration {state.iterations}")

    if render_mode:
        run_render(env, trainer, state)
        return

    sender = MetricSender(project="Reinforcement Learning",
                          group="Rocket League", run_name="torch-2v2",
                          fallback_path=os.path.join(cfg.checkpoint_folder,
                                                     "metrics.jsonl"))
    quit_key = KeyPressDetector("qQ")

    def log(it, metrics):
        rep = Report(metrics)
        print(f"--- iteration {it} "
              f"({metrics['steps_per_second']:,.0f} steps/s) ---")
        print(rep.display())
        sender.send(metrics, step=it)

    try:
        trainer.train(state, iterations, log_fn=log,
                      stop_fn=quit_key.pressed)
    finally:
        sender.close()


if __name__ == "__main__":
    main()
