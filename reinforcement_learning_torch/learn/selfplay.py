"""Self-play services: the policy version bank, ELO skill matches, and
train-against-old-version opponent mixing (PolicyVersionManager.{h,cpp};
Learner.cpp:587-625, 733-778).

Old versions are stacked tensors on the device with a leading version
axis, so picking an opponent is an index into them, not a reload; the
policy runs on a version's parameters through
``PPOLearner.sample_actions(params=...)``.

  * a ring of versions, one snapshot every ``ts_per_version`` (:38-62),
    a new one inheriting the latest rating
  * ELO skill matches on their own eval envs (fuzzed kickoff, goal
    terminal only): rating += inc * (1 - expected), expected from the
    400-based logistic (:156-169)
  * train-against-old mixing: with probability p an old version plays
    one team, and its rows get weight 0 in the PPO batch

The host decisions (which version, which team, whether to continue a
match) draw from the trainer's ``numpy.random.RandomState`` in the JAX
package's order, so they are the JAX package's for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reinforcement_learning_torch.envs import state_setters, terminals
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class SkillTrackerConfig:
    """SkillTrackerConfig.h."""
    enabled: bool = False
    num_arenas: int = 16
    sim_time: float = 45.0
    max_sim_time: float = 240.0
    update_interval: int = 16
    rating_inc: float = 5.0
    initial_rating: float = 0.0
    deterministic: bool = False


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    save_versions: bool = True
    ts_per_version: int = 25_000_000
    max_versions: int = 32
    train_against_old: bool = True
    train_against_old_chance: float = 0.15
    skill: SkillTrackerConfig = SkillTrackerConfig()


def _policy_params(learner) -> dict:
    """The parameters a version keeps: the policy's and the shared
    head's, by ``named_parameters`` name."""
    return {"policy": dict(learner.policy.named_parameters()),
            "shared_head": (dict(learner.shared_head.named_parameters())
                            if learner.has_shared else None)}


@dataclasses.dataclass
class VersionBank:
    """A ring of policy snapshots: each parameter stacked on a leading
    version axis (V, ...) on the learner's device; ratings and timesteps
    on the host."""
    policy: dict                  # name -> (V, ...) tensor
    shared_head: dict | None
    ratings: torch.Tensor         # (V,) float32
    timesteps: torch.Tensor       # (V,) int32
    count: int = 0
    next_slot: int = 0

    @staticmethod
    def make(learner, max_versions: int, initial_rating: float):
        def stack(params):
            if params is None:
                return None
            return {k: torch.zeros((max_versions,) + tuple(p.shape),
                                   dtype=p.dtype, device=p.device)
                    for k, p in params.items()}
        params = _policy_params(learner)
        return VersionBank(
            policy=stack(params["policy"]),
            shared_head=stack(params["shared_head"]),
            ratings=torch.full((max_versions,), initial_rating,
                               dtype=torch.float32),
            timesteps=torch.zeros(max_versions, dtype=torch.int32))


def add_version(bank: VersionBank, learner, timesteps: int) -> VersionBank:
    """Copy the learner's policy into the ring's next slot, the oldest
    version giving way once it is full (PolicyVersionManager.cpp
    AddVersion).  The copy is the bank's own: later updates of the learner
    do not reach it."""
    slot = bank.next_slot
    params = _policy_params(learner)
    with torch.no_grad():
        for group in ("policy", "shared_head"):
            stacked = getattr(bank, group)
            if stacked is not None:
                for k, p in params[group].items():
                    stacked[k][slot].copy_(p.detach())
    bank.ratings[slot] = current_rating(bank)
    bank.timesteps[slot] = timesteps
    bank.count = min(bank.count + 1, bank.ratings.shape[0])
    bank.next_slot = (slot + 1) % bank.ratings.shape[0]
    return bank


def current_rating(bank: VersionBank) -> torch.Tensor:
    """The newest version's rating (new snapshots inherit it, so ratings
    form one curve); the initial rating while the bank is empty."""
    if bank.count > 0:
        return bank.ratings[(bank.next_slot - 1) % bank.ratings.shape[0]]
    return bank.ratings[0]


def get_version(bank: VersionBank, idx: int) -> dict:
    """Version ``idx``'s parameters (views into the bank), as
    ``PPOLearner.sample_actions(params=...)`` takes them."""
    def take(stacked):
        return (None if stacked is None
                else {k: v[idx] for k, v in stacked.items()})
    return {"policy": take(bank.policy),
            "shared_head": take(bank.shared_head)}


def elo_update(winner_rating, loser_rating, inc: float):
    """PolicyVersionManager.cpp:159-169."""
    exp_delta = (loser_rating - winner_rating) / 400.0
    expected = 1.0 / (10.0 ** exp_delta + 1.0)
    return (winner_rating + inc * (1.0 - expected),
            loser_rating - inc * (1.0 - expected))


class SkillTracker:
    """ELO evaluation: the current policy against a random old version on
    its own eval envs (RunSkillMatches, PolicyVersionManager.cpp:
    156-300)."""

    def __init__(self, learner, team_size: int, config: SkillTrackerConfig,
                 tick_skip: int = 8, action_delay: int = 7, device=None):
        self.config = config
        self.learner = learner
        env_cfg = EnvConfig(num_envs=config.num_arenas, team_size=team_size,
                            tick_skip=tick_skip, action_delay=action_delay,
                            max_episode_seconds=1e9, no_touch_timeout=1e9,
                            device=device)
        self.env = RocketLeagueEnv(
            env_cfg, reward_fns=[],
            terminal_conds=[terminals.goal_score_condition()],
            state_setter=state_setters.kickoff_state(fuzz=0.1))
        self.steps_per_run = int(round(
            config.sim_time / env_cfg.step_seconds))
        self.env_states = None
        self.mode_name = f"{team_size}v{team_size}"
        self.iterations_since_ran = 0
        # continuation state (PolicyVersionManager.cpp:289-299)
        self.continuation = False
        self.cur_goals = 0
        self.prev_old_idx = 0
        self.prev_new_team = 0
        self.prev_sim_time = 0.0

    @torch.no_grad()
    def _run(self, learner, old_params, env_states, new_team: int,
             seed: int):
        """``steps_per_run`` eval steps, the current policy on team
        ``new_team`` and the old version on the other, sampling from a
        generator seeded with ``seed``.  Returns (env states, goals of the
        new side, goals of the old side).

        The net a goal went into is read from the ball of
        ``prev_arena`` after the step, as the JAX package does; after the
        goal's auto-reset that is the kickoff ball at y = 0, so every goal
        counts as one into the orange net."""
        env = self.env
        gen = torch.Generator(device=env.device).manual_seed(seed)
        det = self.config.deterministic
        is_new = (env.teams == new_team)[None, :]
        states, obs, masks = env_states
        new_goals = torch.zeros((), dtype=torch.int64, device=env.device)
        old_goals = torch.zeros_like(new_goals)
        for _ in range(self.steps_per_run):
            N, P, D = obs.shape
            flat_obs, flat_masks = obs.reshape(N * P, D), masks.reshape(
                N * P, -1)
            a_new, _ = learner.sample_actions(flat_obs, flat_masks,
                                              generator=gen,
                                              deterministic=det)
            a_old, _ = learner.sample_actions(flat_obs, flat_masks,
                                              generator=gen,
                                              deterministic=det,
                                              params=old_params)
            actions = torch.where(is_new, a_new.reshape(N, P),
                                  a_old.reshape(N, P))
            states, out = env.step(states, actions)
            scored_on_team = torch.where(
                states.prev_arena.ball.pos[:, 1] < 0, 0, 1)
            new_goals += torch.sum(out.goal_scored
                                   & (scored_on_team != new_team))
            old_goals += torch.sum(out.goal_scored
                                   & (scored_on_team == new_team))
            obs, masks = out.obs, out.action_mask
        return (states, obs, masks), new_goals, old_goals

    @tracing.traced("match")
    def run_matches(self, learner, bank: VersionBank,
                    rng: np.random.RandomState):
        """Pick a version and a team, run, apply the ELO rule per goal.

        When too few goals were scored the match CONTINUES next time: the
        same env states, opponent version and team, the accumulated sim
        time capped at ``max_sim_time`` (PolicyVersionManager.cpp:289-299
        "Forcing continuation").

        Returns (bank, current rating, info dict)."""
        count = bank.count
        if count == 0:
            return bank, float(current_rating(bank)), {}
        seed = int(rng.randint(0, 2 ** 31 - 1))
        if self.continuation and self.env_states is not None:
            idx = min(self.prev_old_idx, count - 1)
            new_team = self.prev_new_team
            total_sim_time = self.prev_sim_time + self.config.sim_time
        else:
            idx = int(rng.randint(0, count))
            new_team = int(rng.randint(0, 2))
            total_sim_time = self.config.sim_time
            self.env_states = None
            self.cur_goals = 0
        if self.env_states is None:
            self.env_states = self.env.reset(seed)
        self.env_states, new_goals, old_goals = self._run(
            learner, get_version(bank, idx), self.env_states, new_team,
            seed)
        new_goals, old_goals = int(new_goals), int(old_goals)
        self.cur_goals += new_goals + old_goals
        if (self.cur_goals < self.config.num_arenas
                and total_sim_time < self.config.max_sim_time):
            self.continuation = True
            self.prev_old_idx = idx
            self.prev_new_team = new_team
            self.prev_sim_time = total_sim_time
        else:
            self.continuation = False
            self.cur_goals = 0

        cur = float(current_rating(bank))
        old = float(bank.ratings[idx])
        inc = self.config.rating_inc
        for _ in range(new_goals):
            cur, old = elo_update(cur, old, inc)
        for _ in range(old_goals):
            old, cur = elo_update(old, cur, inc)

        # the old version's rating is written back; the current one goes
        # on into the next snapshot through current_rating()
        last = (bank.next_slot - 1) % bank.ratings.shape[0]
        bank.ratings[idx] = old
        bank.ratings[last] = cur
        info = {"new_goals": new_goals, "old_goals": old_goals,
                "opponent_idx": idx, f"Rating/{self.mode_name}": cur}
        return bank, cur, info
