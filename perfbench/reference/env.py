"""The env's step after the physics, as plain PyTorch: a copy of the
port's ``envs/env.py`` (``RocketLeagueEnv.post_physics``, its reset draw,
observation and action mask) as it was when the benchmark was written,
built from a configuration file instead of the program's factories, on
one process (no sharding), with the physics advanced by ``ops/ctick.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt.device import tree_map
from perfbench.reference.rlt.envs import actions
from perfbench.reference.rlt.envs import events as eventsmod
from perfbench.reference.rlt.envs import kickoff_reward, obs
from perfbench.reference.rlt.envs import rewards as R
from perfbench.reference.rlt.envs import state_setters, terminals
from perfbench.reference.rlt.envs.rewards import (RewardCtx, WeightedReward,
                                                  combine_rewards)
from perfbench.reference.rlt.ops import ctick
from perfbench.reference.rlt.physics.state import NUM_CONTROLS
from perfbench.reference.rlt.physics.step import ArenaParams


@dataclasses.dataclass
class EnvState:
    phys: object
    prev_arena: object
    has_prev: torch.Tensor
    prev_actions: torch.Tensor
    steps_since_touch: torch.Tensor
    steps_since_reset: torch.Tensor
    blue_score: torch.Tensor
    orange_score: torch.Tensor
    tracker: eventsmod.TrackerState


@dataclasses.dataclass
class StepOutput:
    obs: torch.Tensor
    final_obs: torch.Tensor
    reward: torch.Tensor
    terminal_type: torch.Tensor
    action_mask: torch.Tensor
    ball_touched: torch.Tensor
    goal_scored: torch.Tensor
    reward_components: dict


@dataclasses.dataclass
class TerminalCtx:
    goal_scored: torch.Tensor
    steps_since_touch: torch.Tensor
    steps_since_reset: torch.Tensor
    blue_score: torch.Tensor
    orange_score: torch.Tensor


def _reward(spec: dict):
    """A reward function from its entry in a configuration file's
    ``rewards``: ``fn`` names a function of the rewards or kickoff-reward
    module, ``kwargs`` its arguments; ``zero_sum`` wraps it."""
    fn = getattr(R, spec["fn"], None) or getattr(kickoff_reward, spec["fn"])
    inner = fn(**spec.get("kwargs", {}))
    if "zero_sum" in spec:
        inner = R.zero_sum(inner, **spec["zero_sum"])
    return inner


def _terminal(spec: dict, step_seconds: float):
    fn = getattr(terminals, spec["fn"])
    if "seconds" in spec:
        return fn(spec["seconds"], step_seconds)
    return fn(**spec.get("kwargs", {}))


def env_spec(config: dict, match: bool = False) -> dict:
    """The env of a configuration file: its ``env`` with the builders,
    rewards, terminals and state setter named at the top level; with
    ``match``, the skill match's env, whose differences the file states
    under ``selfplay.skill.env``."""
    spec = dict(config["env"])
    for key in ("obs", "action_parser", "rewards", "terminals",
                "state_setter"):
        spec[key] = config[key]
    spec["state_setter_kwargs"] = config.get("state_setter_kwargs", {})
    if match:
        spec.update(config["selfplay"]["skill"]["env"])
    return spec


class RefEnv:
    """The env of a configuration file on ``device`` (with ``match``, the
    skill match's).  ``draw_envs``: the arenas every reset draw is made
    for, of which the block from arena ``offset`` on is kept, as a
    data-parallel rank draws at the global width and keeps its block (by
    default the arenas stepped)."""

    def __init__(self, config: dict, device, match: bool = False,
                 draw_envs: int | None = None, offset: int = 0):
        envc = env_spec(config, match)
        self.draw_envs, self.offset = draw_envs, offset
        self.device = torch.device(device)
        self.tick_skip = envc["tick_skip"]
        self.action_delay = envc["action_delay"]
        P = envc["team_size"] * 2
        self.teams_np = np.array([0] * envc["team_size"]
                                 + [1] * envc["team_size"], np.int32)
        self.teams = torch.as_tensor(self.teams_np, device=self.device)
        self.params = ArenaParams(
            num_cars=P, game_mode=envc["game_mode"],
            use_mesh=envc["use_mesh"],
            dynamic_wheel_rays=envc["dynamic_wheel_rays"])
        self.consts = ctick.make_consts(self.params,
                                        tuple(int(t) for t in self.teams_np))
        self.obs_builder = getattr(obs, envc["obs"])(P, self.teams_np,
                                                     self.device)
        self.action_parser = getattr(actions, envc["action_parser"])(
            self.device)
        self.reward_fns = [WeightedReward(_reward(r), r["weight"])
                           for r in envc["rewards"]]
        built = [w.name for w in self.reward_fns]
        names = [r["name"] for r in envc["rewards"]]
        if built != names:
            raise ValueError(f"rewards built {built}, configuration file "
                             f"{names}")
        self.reward_combined = combine_rewards(self.reward_fns)
        step_seconds = self.tick_skip / 120.0
        self.terminal_fn = terminals.combine_conditions(
            [_terminal(t, step_seconds) for t in envc["terminals"]])
        self.state_setter = getattr(state_setters, envc["state_setter"])(
            **envc["state_setter_kwargs"])
        self.event_config = eventsmod.EventConfig()
        self.generator = torch.Generator(device=self.device)

    def physics_step(self, phys, controls, respawn_idx):
        return ctick.arena_step_reference(phys, controls, respawn_idx,
                                          self.consts, self.tick_skip,
                                          self.action_delay)

    def respawn_idx(self, N: int) -> torch.Tensor:
        """The respawn-table draw of one env step for ``N`` arenas, each
        car's, made as the reset draw is (the kernel's route: one a car an
        env step)."""
        drawn, at = max(self.draw_envs or N, N), self.offset
        idx = torch.randint(0, C.CAR_RESPAWN_LOCATION_AMOUNT,
                            (drawn, self.teams.shape[0]),
                            generator=self.generator, device=self.device,
                            dtype=torch.int32)
        return idx[at:at + N]

    def _reset_states(self, N: int) -> EnvState:
        P = self.teams.shape[0]
        dev = self.device
        drawn, at = max(self.draw_envs or N, N), self.offset
        phys = self.state_setter(self.generator, self.params, self.teams,
                                 drawn, dev)
        if drawn != N:
            phys = tree_map(lambda x: x[at:at + N], phys)
        zi = lambda: torch.zeros(N, dtype=torch.int32, device=dev)  # noqa
        return EnvState(
            phys=phys, prev_arena=phys.arena,
            has_prev=torch.zeros(N, dtype=torch.bool, device=dev),
            prev_actions=torch.zeros(N, P, NUM_CONTROLS, device=dev),
            steps_since_touch=zi(), steps_since_reset=zi(),
            blue_score=zi(), orange_score=zi(),
            tracker=eventsmod.TrackerState.make(N, dev))

    def obs(self, state: EnvState) -> torch.Tensor:
        a = state.phys.arena
        return self.obs_builder.build(a.cars, a.ball, a.pads,
                                      state.prev_actions)

    def action_mask(self, state: EnvState) -> torch.Tensor:
        return self.action_parser.action_mask(state.phys.arena.cars)

    def post_physics(self, state: EnvState, phys, controls):
        arena = phys.arena
        tick = arena.tick_count
        touched = arena.cars.ball_hit_valid & (
            arena.cars.ball_hit_tick >= (tick - self.tick_skip)[:, None])

        tracker, ev = eventsmod.update_tracker(
            state.tracker, arena.cars, arena.ball, self.teams, tick,
            arena.goal_scored, self.tick_skip, self.params.mutators,
            self.event_config)
        ev = dict(ev, bump=arena.step_bump, bumped=arena.step_bumped,
                  demo=arena.step_demo, demoed=arena.step_demoed)

        steps_since_touch = torch.where(touched.any(-1), 0,
                                        state.steps_since_touch + 1)
        steps_since_reset = state.steps_since_reset + 1
        blue_side = arena.ball.pos[:, 1] > 0
        blue_score = state.blue_score + (arena.goal_scored
                                         & blue_side).to(torch.int32)
        orange_score = state.orange_score + (arena.goal_scored
                                             & ~blue_side).to(torch.int32)
        terminal_type = self.terminal_fn(TerminalCtx(
            goal_scored=arena.goal_scored,
            steps_since_touch=steps_since_touch,
            steps_since_reset=steps_since_reset,
            blue_score=blue_score, orange_score=orange_score))

        reward, components = self.reward_combined(RewardCtx(
            cars=arena.cars, prev_cars=state.phys.arena.cars,
            ball=arena.ball, prev_ball=state.phys.arena.ball,
            teams=self.teams, ball_touched_step=touched,
            goal_scored=arena.goal_scored, has_prev=state.has_prev,
            is_final=terminal_type, events=ev, blue_score=blue_score,
            orange_score=orange_score))

        next_state = EnvState(
            phys=phys, prev_arena=arena,
            has_prev=torch.ones_like(state.has_prev),
            prev_actions=controls,
            steps_since_touch=steps_since_touch.to(torch.int32),
            steps_since_reset=steps_since_reset,
            blue_score=blue_score, orange_score=orange_score,
            tracker=tracker)
        final_obs = self.obs(next_state)

        is_terminal = terminal_type != terminals.NOT_TERMINAL
        reset_state = self._reset_states(is_terminal.shape[0])
        next_state = tree_map(
            lambda r, n: torch.where(
                is_terminal.reshape((-1,) + (1,) * (n.dim() - 1)), r, n),
            reset_state, next_state)

        out = StepOutput(
            obs=self.obs(next_state), final_obs=final_obs, reward=reward,
            terminal_type=terminal_type,
            action_mask=self.action_mask(next_state),
            ball_touched=touched, goal_scored=arena.goal_scored,
            reward_components=components)
        return next_state, out
