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

Sharded over the env axis (``parallel/mesh.py``, the env's ``shard``), a
rank collects on its block of the arenas: the policy's Gumbel noise is
drawn at the global shape and the rank keeps its rows, every metric and
the Welford statistics are global (all-reduced), GAE stays local (it runs
per column), and the update all-reduces its gradients.  The self-play host
logic draws from a replicated generator, so every rank takes the same
decisions (and plays the same skill matches) with no collective; rank 0
logs and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.envs.env import EnvState, RocketLeagueEnv
from reinforcement_learning_torch.learn import gae as gaemod
from reinforcement_learning_torch.learn import selfplay as sp
from reinforcement_learning_torch.learn import welford
from reinforcement_learning_torch.learn.ppo import PPOConfig, PPOLearner
from reinforcement_learning_torch.utils import tracing


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

    def map_envs(self, fn) -> "TrainState":
        """``fn`` applied to the env-batched parts (``env_states``, ``obs``,
        ``masks``; leading axis the arenas); the rest as it is."""
        return dataclasses.replace(
            self, env_states=tree_map(fn, self.env_states),
            obs=fn(self.obs), masks=fn(self.masks))


class Trainer:
    @tracing.traced("setup.trainer")
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

    @property
    def generator_states(self) -> list:
        """The states of the generators the trainer owns (its own, the
        env's, the self-play host's), for a data-parallel run to copy
        rank 0's to every rank."""
        return [self.generator.get_state(), self.env.generator.get_state(),
                self._host_rng.get_state()]

    @generator_states.setter
    def generator_states(self, states: list):
        self.generator.set_state(states[0])
        self.env.generator.set_state(states[1])
        self._host_rng.set_state(states[2])

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
    @tracing.traced("iter.collect")
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
                flat_obs, flat_masks, gumbel=self._gumbel(masks, det),
                deterministic=det)
            act_grid = actions.reshape(N, P)
            if opponent is not None:
                old_actions, _ = learner.sample_actions(
                    flat_obs, flat_masks, gumbel=self._gumbel(masks, det),
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
                reward_components={k: v.sum() for k, v in
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
        traj["reward_components"] = self._component_means(
            traj["reward_components"], out.reward_components)
        return dataclasses.replace(state, env_states=env_states, obs=obs,
                                   masks=masks), traj

    def _gumbel(self, masks, deterministic: bool):
        """The policy's Gumbel noise for ``masks``' rows (N, P, A): drawn
        from the trainer's generator at the global (E * P, A) shape, this
        rank's rows of it.  None when sampling is deterministic."""
        if deterministic:
            return None
        shard = self.env.shard
        P, A = masks.shape[1:]
        e = torch.empty(shard.global_envs * P, A, device=masks.device
                        ).exponential_(generator=self.generator)
        return -torch.log(shard.take_rows(e, P))

    def _component_means(self, sums: dict, last: dict) -> dict:
        """Per-step sums of the reward components (name -> (T,)) as
        per-step means over every arena and player: one all-reduce for all
        of them.  ``last``: one step's components, for their shapes."""
        if not sums:
            return {}
        shard = self.env.shard
        stacked = shard.all_sum(torch.stack(list(sums.values())))
        counts = torch.tensor(
            [last[k].numel() // shard.local_envs * shard.global_envs
             for k in sums], dtype=torch.float32, device=stacked.device)
        return dict(zip(sums, stacked / counts[:, None]))

    @tracing.traced("iter.learn")
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
        metrics = {**self.learner.update(
            data, generator=self.generator, perms=perms,
            guiding=self.guiding, shard=self.env.shard,
            players=traj["action"].shape[2]), **metrics}
        return state, metrics

    @tracing.traced("iter.prepare", device="env.device")
    def prepare(self, state: TrainState, traj: dict):
        """Values, GAE and the Welford updates of a collected ``traj``.
        Returns (state with the new statistics and counters, the update's
        flat rows, the iteration's metrics other than the update's).
        Sharded, the statistics and metrics are over every rank's rows."""
        cfg, learner = self.config, self.learner
        shard = self.env.shard
        T, N, P = traj["action"].shape

        def flat(x):
            return x.reshape((T * N * P,) + tuple(x.shape[3:]))

        with tracing.span("prepare.values"):
            v_obs = learner.values(flat(traj["obs"]), half=False)
            v_final = learner.values(flat(traj["final_obs"]), half=False)

        with tracing.span("prepare.gae"):
            terminal_tb = traj["terminal"].repeat_interleave(P, dim=-1)
            return_std = (state.return_stat.std if cfg.standardize_returns
                          else torch.ones((), device=v_obs.device))
            advs, target_values, returns, clip_portion = gaemod.compute_gae(
                traj["reward"].reshape(T, N * P), terminal_tb,
                v_obs.reshape(T, N * P), v_final.reshape(T, N * P),
                gamma=self.ppo_config.gae_gamma,
                lam=self.ppo_config.gae_lambda, return_std=return_std,
                reward_clip_range=self.ppo_config.reward_clip_range,
                all_sum=shard.all_sum)

        with tracing.span("prepare.welford"):
            return_stat = welford.update_batch(
                state.return_stat, returns.reshape(-1), shard.all_sum)
            obs_stat = state.obs_stat
            if cfg.standardize_obs:
                obs_stat = welford.update_batch(
                    obs_stat, traj["obs"].reshape(-1, traj["obs"].shape[-1]),
                    shard.all_sum)

        data = dict(obs=flat(traj["obs"]), mask=flat(traj["mask"]),
                    action=flat(traj["action"]),
                    old_logp=flat(traj["old_logp"]),
                    advantage=advs.reshape(-1),
                    target_value=target_values.reshape(-1))
        # every metric over the rows of every rank: a (sum, weight sum) pair
        # per mean, a weight of 1 a row unless the metric brings its own,
        # and the count of terminals, summed over the ranks at once
        means = {"reward_mean": traj["reward"], "goal_rate": traj["goal"],
                 "touch_rate": traj["touch"], "value_mean": v_obs,
                 **traj.get("user_metrics", {})}
        parts = []
        for v in means.values():
            x, w = v if isinstance(v, tuple) else (v, torch.ones_like(v))
            x, w = x.to(torch.float32), w.to(torch.float32)
            parts += [torch.sum(x * w), torch.sum(w)]
        parts.append(torch.sum((traj["terminal"] > 0).to(torch.float32)))
        totals = shard.all_sum(torch.stack(parts))
        metrics = {k: totals[2 * i] / torch.clamp(totals[2 * i + 1], min=1.0)
                   for i, k in enumerate(means)}
        metrics["episode_terminals"] = totals[-1]
        metrics["return_std"] = return_stat.std
        metrics["reward_clip_portion"] = clip_portion
        for name, v in traj["reward_components"].items():
            metrics[f"reward/{name}"] = torch.mean(v)
        state = dataclasses.replace(
            state, return_stat=return_stat, obs_stat=obs_stat,
            total_timesteps=state.total_timesteps
            + T * shard.global_envs * P,
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

    @tracing.traced("iter")
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
        trainer's state and its generators are restored.  A data-parallel
        run resumes before ``shard_train_state``: a checkpoint holds every
        arena."""
        from reinforcement_learning_torch.utils import checkpoint as ckpt

        if self.env.shard.sharded:
            raise ValueError("call init_or_resume before shard_train_state")
        state = self.init(seed)
        if self.config.checkpoint_folder:
            restored, _ = ckpt.load_latest(self.config.checkpoint_folder,
                                           self, state)
            if restored is not None:
                return restored
        return state

    @tracing.traced("save")
    def save(self, state: TrainState) -> str | None:
        """Checkpoint now (Learner::Save, Learner.cpp:224-257); returns
        its folder, or None without a checkpoint folder.  Sharded, every
        rank takes part in gathering the whole state and rank 0 writes it
        (the other ranks return None)."""
        from reinforcement_learning_torch.utils import checkpoint as ckpt

        if not self.config.checkpoint_folder:
            return None
        state = state.map_envs(self.env.shard.gather)
        if self.env.shard.rank != 0:
            return None
        return ckpt.save_checkpoint(self.config.checkpoint_folder, self,
                                    state,
                                    keep=self.config.checkpoints_to_keep)

    def train(self, state: TrainState, num_iterations: int, log_fn=None,
              stop_fn=None) -> TrainState:
        """Run iterations.  ``log_fn(iteration, metrics)`` gets the metrics
        as floats, the self-play metrics among them, with
        ``steps_per_second`` and ``iteration_time``, read after the device
        has finished; with the tracer's spans on (``utils.tracing``), also
        its timing block (``timing_metrics``), and the tracer is cleared
        after each iteration.  With a checkpoint folder, saves every
        ``ts_per_save`` collected steps and once at the end
        (Learner.cpp:1011-1015); ``stop_fn()`` True ends training after
        that final save (the reference's 'Q' save-and-quit,
        Learner.cpp:281-298, 1005-1009).  Sharded, rank 0 alone calls
        ``log_fn`` and ``stop_fn``, and its answer stops every rank on the
        same iteration."""
        cuda = self.env.device.type == "cuda"
        shard = self.env.shard
        root = shard.rank == 0
        last_save_ts = state.total_timesteps
        for _ in range(num_iterations):
            t0 = time.perf_counter()
            state, metrics = self.train_iteration(state)
            if cuda:
                torch.cuda.synchronize(self.env.device)
            dt = time.perf_counter() - t0
            if log_fn is not None and root:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(self.last_selfplay_metrics)
                m["steps_per_second"] = (
                    self.steps_per_itr * self.players_per_step / dt)
                m["iteration_time"] = dt
                if tracing.enabled():
                    m.update(timing_metrics())
                log_fn(state.iterations, m)
            if tracing.enabled():
                tracing.reset()
            if (self.config.checkpoint_folder
                    and state.total_timesteps - last_save_ts
                    >= self.config.ts_per_save):
                self.save(state)
                last_save_ts = state.total_timesteps
            if stop_fn is not None and shard.from_root(
                    root and stop_fn(), self.env.device):
                break
        if self.config.checkpoint_folder:
            self.save(state)
        return state


def timing_metrics() -> dict:
    """The operator's timing block (GigaLearnCPP's Report timings,
    Learner.cpp:646-994) from what the tracer holds: ``timing/<span>_ms``
    for each span name, in device ms where the device timed it (the
    preparation and the update on the card), else in host ms, and
    ``count/<counter>`` for each counter.  ``Trainer.train`` clears the
    tracer after each iteration, so the first iteration's block holds
    set-up's spans and an iteration's holds the checkpoint saved after
    the one before it.  The env step's spans count the skill match's
    steps too, which ``timing/match_ms`` holds whole.  Read once the
    device has finished."""
    s = tracing.summary()
    out = {f"timing/{name}_ms": v.get("device_ms", v["total_ms"])
           for name, v in s["spans"].items()}
    out.update({f"count/{name}": float(n)
                for name, n in s["counters"].items()})
    return out


def _stack(values):
    """Stack per-step tensors, or per-step (value, weight) pairs into a
    pair of stacks."""
    if isinstance(values[0], tuple):
        return tuple(torch.stack(list(part)) for part in zip(*values))
    return torch.stack(values)
