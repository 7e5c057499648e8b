"""Trainer: one training iteration is collect -> values -> GAE -> Welford
stats -> PPO update (the JAX package's ``Trainer._train_iteration_impl``;
GigaLearnCPP Learner.cpp:482-1056).

  collect: T x (policy sample -> env step -> store), bf16 inference
  values: one fp32 critic pass over the stored and the final observations
  GAE: a reverse loop over (T, N*P), each arena's terminal per player
  learn: PPO epochs over shuffled minibatches

Around it, ``train_iteration`` runs the self-play host logic (version
snapshots, opponent mixing, skill matches; Learner.cpp:587-625), and
``train`` saves checkpoints on its cadence; ``init_or_resume`` picks up
the newest one (Learner.cpp:145-146, 224-279).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from reinforcement_learning_torch.envs.env import EnvState, RocketLeagueEnv
from reinforcement_learning_torch.learn import gae as gaemod
from reinforcement_learning_torch.learn import selfplay as sp
from reinforcement_learning_torch.learn import welford
from reinforcement_learning_torch.learn.ppo import PPOConfig, PPOLearner


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """LearnerConfig (LearnerConfig.h:14-71), without the fields of device
    selection and render pacing."""
    ts_per_itr: int = 50_000
    standardize_returns: bool = True
    standardize_obs: bool = False
    min_obs_std: float = 0.1
    max_obs_mean_range: float = 3.0
    checkpoint_folder: str = ""
    ts_per_save: int = 10_000_000
    checkpoints_to_keep: int = 8
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
                 learner: PPOLearner | None = None,
                 selfplay: "sp.SelfPlayConfig | None" = None,
                 step_metrics_fn=None, guiding_params=None):
        """``step_metrics_fn(env_states, out) -> dict[str, tensor or
        (tensor, weight)]``: per-step user metrics (StepCallback,
        ExampleMain.cpp:232-254), averaged over the iteration, a
        ``(value, weight)`` pair as the weighted mean of the values
        (Report::AddAvg called only on qualifying events).

        ``guiding_params``: a frozen guiding policy, a ``PPOLearner`` or
        the JAX package's parameter tree, which an L1 term scaled by
        ``ppo_config.guiding_strength`` pulls the policy toward
        (PPOLearnerConfig.h:55-57, PPOLearner.cpp:458-468)."""
        self.env = env
        self.config = config
        self.ppo_config = ppo_config
        self.step_metrics_fn = step_metrics_fn
        if guiding_params is not None and ppo_config.guiding_strength <= 0:
            raise ValueError("guiding_params given but "
                             "ppo_config.guiding_strength is 0")
        self.learner = learner or PPOLearner(
            env.obs_size, env.num_actions, ppo_config, device=env.device,
            seed=config.random_seed)
        self.guiding = (self.learner.guide(guiding_params)
                        if guiding_params is not None else None)
        n_players = env.config.num_envs * env.config.cars_per_arena
        # env steps per iteration so that collected player-steps >= target
        self.steps_per_itr = max(config.ts_per_itr // n_players, 1)
        self.players_per_step = n_players
        self.generator = torch.Generator(device=env.device).manual_seed(
            config.random_seed)

        # self-play services (PolicyVersionManager + opponent mixing)
        self.selfplay = selfplay
        self.bank: "sp.VersionBank | None" = None
        self.skill_tracker = None
        self.last_selfplay_metrics = {}
        self._host_rng = np.random.RandomState(config.random_seed)
        if selfplay is not None and selfplay.skill.enabled:
            self.skill_tracker = sp.SkillTracker(
                self.learner, env.config.team_size, selfplay.skill,
                env.config.tick_skip, env.config.action_delay,
                device=env.device)

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
    def collect(self, state: TrainState, T: int | None = None,
                opponent=None, old_team: int = 0):
        """Run ``T`` env steps (default ``steps_per_itr``).  Returns (state,
        traj) with traj keys as in the JAX package: obs, mask, action,
        old_logp, reward, terminal, final_obs, goal, touch (each stacked on
        a leading T axis), reward_components (name -> (T,) means) and,
        with a ``step_metrics_fn``, user_metrics (name -> stacked values,
        or a pair of stacked values and weights).

        ``opponent``: an old version's parameters (``sp.get_version``);
        the players of team ``old_team`` then take its actions, sampled
        after the current policy's each step (``old_logp`` stays the
        current policy's)."""
        T = self.steps_per_itr if T is None else T
        learner, env = self.learner, self.env
        det = self.ppo_config.deterministic
        env_states, obs, masks = state.env_states, state.obs, state.masks
        is_old = (env.teams == old_team)[None, :]
        steps = []
        for _ in range(T):
            N, P, D = obs.shape
            obs_in = self._maybe_std(state, obs)
            flat_obs, flat_masks = obs_in.reshape(N * P, D), masks.reshape(
                N * P, -1)
            actions, logp = learner.sample_actions(
                flat_obs, flat_masks, generator=self.generator,
                deterministic=det)
            act_grid = actions.reshape(N, P)
            if opponent is not None:
                old_actions, _ = learner.sample_actions(
                    flat_obs, flat_masks, generator=self.generator,
                    deterministic=det, params=opponent)
                act_grid = torch.where(is_old, old_actions.reshape(N, P),
                                       act_grid)
            env_states, out = env.step(env_states, act_grid)
            step = dict(
                obs=obs_in, mask=masks, action=act_grid,
                old_logp=logp.reshape(N, P), reward=out.reward,
                terminal=out.terminal_type,
                final_obs=self._maybe_std(state, out.final_obs),
                goal=out.goal_scored, touch=out.ball_touched,
                reward_components={k: v.mean() for k, v in
                                   out.reward_components.items()})
            if self.step_metrics_fn is not None:
                step["user_metrics"] = self.step_metrics_fn(env_states, out)
            steps.append(step)
            obs, masks = out.obs, out.action_mask
        nested = ("reward_components", "user_metrics")
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]
                if k not in nested}
        for k in nested:
            if k in steps[0]:
                traj[k] = {name: _stack([s[k][name] for s in steps])
                           for name in steps[0][k]}
        return dataclasses.replace(state, env_states=env_states, obs=obs,
                                   masks=masks), traj

    def learn(self, state: TrainState, traj: dict, perms=None,
              weight=None):
        """The learning half of an iteration on a collected ``traj``
        (``_train_iteration_impl`` from the values pass on): ``prepare``,
        then the PPO update (``perms``: see ``PPOLearner.update``), with
        ``weight`` (one per row, 0 leaves a row out) and the guiding
        policy.  Returns (state, metrics) with the iteration's metric
        keys; the metrics stay on the device."""
        state, data, metrics = self.prepare(state, traj)
        if weight is not None:
            data["weight"] = weight
        metrics = {**self.learner.update(data, generator=self.generator,
                                         perms=perms,
                                         guiding=self.guiding), **metrics}
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
        for name, vals in traj.get("user_metrics", {}).items():
            if isinstance(vals, tuple):
                v, w = vals
                w = w.to(torch.float32)
                metrics[name] = torch.sum(v * w) / torch.clamp(
                    torch.sum(w), min=1.0)
            else:
                metrics[name] = torch.mean(vals.to(torch.float32))
        state = dataclasses.replace(
            state, return_stat=return_stat, obs_stat=obs_stat,
            total_timesteps=state.total_timesteps + T * N * P,
            iterations=state.iterations + 1)
        return state, data, metrics

    def _train_iteration(self, state: TrainState, opponent=None,
                         old_team: int = 0, use_old: bool = False):
        """The iteration's core: ``collect`` (against ``opponent`` on team
        ``old_team`` when ``use_old``) then ``learn``, the old team's rows
        weighted 0."""
        if not use_old:
            state, traj = self.collect(state)
            return self.learn(state, traj)
        state, traj = self.collect(state, opponent=opponent,
                                   old_team=old_team)
        T, N, P = traj["action"].shape
        weight = (self.env.teams != old_team).to(torch.float32)
        return self.learn(state, traj,
                          weight=weight.expand(T, N, P).reshape(-1))

    def train_iteration(self, state: TrainState):
        """One iteration, with the self-play host logic around its core
        (Learner.cpp:587-625 + versionMgr->OnIteration).  Returns (state,
        metrics); the metrics are tensors on the device, and the host
        logic's own go to ``last_selfplay_metrics``."""
        spc = self.selfplay
        self.last_selfplay_metrics = {}
        extra = self.last_selfplay_metrics
        if spc is None:
            return self._train_iteration(state)

        if self.bank is None:
            self.bank = sp.VersionBank.make(self.learner, spc.max_versions,
                                            spc.skill.initial_rating)

        # snapshot a version on the ts_per_version boundary (OnIteration)
        ts = state.total_timesteps
        if spc.save_versions:
            prev_ts = ts - self.steps_per_itr * self.players_per_step
            if self.bank.count == 0 or (ts // spc.ts_per_version
                                        > max(prev_ts, 0)
                                        // spc.ts_per_version):
                sp.add_version(self.bank, self.learner, min(ts, 2**31 - 1))

        # opponent mixing
        count = self.bank.count
        use_old = (spc.train_against_old and count > 0
                   and self._host_rng.rand() < spc.train_against_old_chance)
        if use_old:
            idx = int(self._host_rng.randint(0, count))
            old_team = int(self._host_rng.randint(0, 2))
            result = self._train_iteration(state, sp.get_version(self.bank,
                                                                 idx),
                                           old_team, use_old=True)
            extra["trained_against_old"] = 1.0
        else:
            result = self._train_iteration(state)

        # skill matches on the update interval
        if self.skill_tracker is not None:
            self.skill_tracker.iterations_since_ran += 1
            if (self.skill_tracker.iterations_since_ran
                    >= spc.skill.update_interval and count > 0):
                self.skill_tracker.iterations_since_ran = 0
                self.bank, _, info = self.skill_tracker.run_matches(
                    self.learner, self.bank, self._host_rng)
                extra.update({k: float(v) for k, v in info.items()})
        return result

    def init_or_resume(self, seed: int | None = None) -> TrainState:
        """``init``, then the newest checkpoint in
        ``config.checkpoint_folder`` if there is one (the reference's
        auto-load of the newest on construction, Learner.cpp:145-146,
        259-279): the learner's parameters and optimiser states, the
        trainer's state and its generators are restored."""
        from reinforcement_learning_torch.utils import checkpoint as ckpt

        state = self.init(seed)
        if self.config.checkpoint_folder:
            restored, _ = ckpt.load_latest(self.config.checkpoint_folder,
                                           self, state)
            if restored is not None:
                return restored
        return state

    def save(self, state: TrainState) -> str | None:
        """Checkpoint now (Learner::Save, Learner.cpp:224-257); returns
        its folder, or None without a checkpoint folder."""
        from reinforcement_learning_torch.utils import checkpoint as ckpt

        if not self.config.checkpoint_folder:
            return None
        return ckpt.save_checkpoint(self.config.checkpoint_folder, self,
                                    state,
                                    keep=self.config.checkpoints_to_keep)

    def train(self, state: TrainState, num_iterations: int, log_fn=None,
              stop_fn=None) -> TrainState:
        """Run iterations.  ``log_fn(iteration, metrics)`` gets the metrics
        as floats, the self-play metrics among them, with
        ``steps_per_second`` and ``iteration_time``, read after the device
        has finished.  With a checkpoint folder, saves every
        ``ts_per_save`` collected steps and once at the end
        (Learner.cpp:1011-1015); ``stop_fn()`` True ends training after
        that final save (the reference's 'Q' save-and-quit,
        Learner.cpp:281-298, 1005-1009)."""
        cuda = self.env.device.type == "cuda"
        last_save_ts = state.total_timesteps
        for _ in range(num_iterations):
            t0 = time.perf_counter()
            state, metrics = self.train_iteration(state)
            if cuda:
                torch.cuda.synchronize(self.env.device)
            dt = time.perf_counter() - t0
            if log_fn is not None:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(self.last_selfplay_metrics)
                m["steps_per_second"] = (
                    self.steps_per_itr * self.players_per_step / dt)
                m["iteration_time"] = dt
                log_fn(state.iterations, m)
            if (self.config.checkpoint_folder
                    and state.total_timesteps - last_save_ts
                    >= self.config.ts_per_save):
                self.save(state)
                last_save_ts = state.total_timesteps
            if stop_fn is not None and stop_fn():
                break
        if self.config.checkpoint_folder:
            self.save(state)
        return state


def _stack(values):
    """Stack per-step tensors, or per-step (value, weight) pairs into a
    pair of stacks."""
    if isinstance(values[0], tuple):
        return tuple(torch.stack(list(part)) for part in zip(*values))
    return torch.stack(values)
