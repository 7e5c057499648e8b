"""Vectorized environment: N arenas stepped in lockstep on one device.

The JAX package vmaps a one-arena step; here every function is written
over a leading env axis ``N`` (players ``P`` next).  The physics advance
takes one of two routes (``EnvConfig.physics_backend``): the kernel route,
one launch of the arena-step kernel (``ops.arena_step``), or the portable
route, the batched torch engine of ``physics.step`` (hoops and real
``.cmf`` assets).  Observations, rewards, terminals and auto-reset are
plain tensor code around it.

Auto-reset: terminal arenas are re-seeded by the state setter in the same
step (EnvSet::Reset semantics); the pre-reset observation is returned as
``final_obs`` for truncation bootstrapping.

Data parallelism (``parallel/mesh.py``): a rank steps its block of the
arenas (``shard``), and draws every reset state and respawn index at the
global shape, keeping its block, so that it draws what the unsharded env
draws for those arenas.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch.device import resolve_device, tree_map
from reinforcement_learning_torch.envs import events as eventsmod
from reinforcement_learning_torch.envs import rewards as R
from reinforcement_learning_torch.envs import state_setters, terminals
from reinforcement_learning_torch.envs.actions import DefaultAction
from reinforcement_learning_torch.envs.obs import AdvancedObs
from reinforcement_learning_torch.envs.rewards import (RewardCtx,
                                                       WeightedReward,
                                                       combine_rewards)
from reinforcement_learning_torch.envs.shard import EnvShard
from reinforcement_learning_torch.ops.arena_step import arena_step
from reinforcement_learning_torch.ops.ctick import GAME_MODES, check_supported
from reinforcement_learning_torch.physics import step as stepmod
from reinforcement_learning_torch.physics import world as worldmod
from reinforcement_learning_torch.physics.state import NUM_CONTROLS
from reinforcement_learning_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """EnvSetConfig plus the plugin set (EnvSet.h:26-33)."""
    num_envs: int = 64
    team_size: int = 1
    spawn_opponents: bool = True
    tick_skip: int = 8
    action_delay: int = 7
    game_mode: str = "soccar"
    arena: stepmod.ArenaParams = None   # filled in by the env
    no_touch_timeout: float = 30.0
    max_episode_seconds: float = 300.0
    device: str | None = None           # None: "cuda"
    # "kernel": the arena-step kernel (the JAX package's "pallas"; soccar,
    # heatseeker and snowday on the procedural arena).  "portable": the
    # batched torch engine of physics.step (the JAX package's "xla"; every
    # mode, real .cmf assets).  "auto": the kernel wherever it runs, else
    # the portable engine (hoops, real assets).
    physics_backend: str = "auto"

    @property
    def cars_per_arena(self) -> int:
        return self.team_size * (2 if self.spawn_opponents else 1)

    @property
    def step_seconds(self) -> float:
        return self.tick_skip / 120.0

    def make_teams(self) -> np.ndarray:
        teams = np.zeros(self.cars_per_arena, np.int32)
        if self.spawn_opponents:
            teams[self.team_size:] = 1
        return teams


@dataclasses.dataclass
class EnvState:
    """Every arena's env state; leading axis N."""
    phys: stepmod.PhysicsState
    prev_arena: object                # ArenaState of the previous step
    has_prev: torch.Tensor            # (N,) bool
    prev_actions: torch.Tensor        # (N, P, 8) controls shown in the obs
    steps_since_touch: torch.Tensor   # (N,) int32
    steps_since_reset: torch.Tensor   # (N,) int32
    blue_score: torch.Tensor          # (N,) int32 goals since reset
    orange_score: torch.Tensor        # (N,) int32
    tracker: eventsmod.TrackerState


@dataclasses.dataclass
class StepOutput:
    obs: torch.Tensor           # (N, P, obs_size), after auto-reset
    final_obs: torch.Tensor     # (N, P, obs_size), before it
    reward: torch.Tensor        # (N, P)
    terminal_type: torch.Tensor  # (N,) int32
    action_mask: torch.Tensor   # (N, P, A) bool
    ball_touched: torch.Tensor  # (N, P) bool
    goal_scored: torch.Tensor   # (N,) bool
    reward_components: dict     # name -> (N, P)


@dataclasses.dataclass
class TerminalCtx:
    goal_scored: torch.Tensor
    steps_since_touch: torch.Tensor
    steps_since_reset: torch.Tensor
    blue_score: torch.Tensor
    orange_score: torch.Tensor


class RocketLeagueEnv:
    """N-arena environment on ``config.device`` (default ``"cuda"``)."""

    @tracing.traced("setup.env")
    def __init__(self, config: EnvConfig,
                 reward_fns: Sequence[WeightedReward] | None = None,
                 obs_builder=None, action_parser=None,
                 terminal_conds=None, state_setter=None,
                 event_config: eventsmod.EventConfig | None = None):
        """``obs_builder`` and ``action_parser`` default to AdvancedObs
        and DefaultAction on the env's device; one given must live on
        it."""
        if config.arena is None:
            config = dataclasses.replace(config, arena=stepmod.ArenaParams(
                num_cars=config.cars_per_arena, game_mode=config.game_mode))
        self.config = config
        self.device = resolve_device(config.device)
        self.params = config.arena
        self.portable = self._use_portable()
        if not self.portable:
            check_supported(self.params)
        self.teams_np = config.make_teams()
        self.teams = torch.as_tensor(self.teams_np, device=self.device)
        P = config.cars_per_arena

        self.obs_builder = obs_builder or AdvancedObs(P, self.teams_np,
                                                      self.device)
        self.action_parser = action_parser or DefaultAction(self.device)
        self.reward_fns = list(reward_fns) if reward_fns is not None else [
            WeightedReward(R.velocity_player_to_ball_reward(), 0.3),
            WeightedReward(R.touch_ball_reward(), 1.0),
            WeightedReward(R.goal_reward(), 30.0),
        ]
        self.reward_combined = combine_rewards(self.reward_fns)
        self.terminal_fn = terminals.combine_conditions(
            terminal_conds if terminal_conds is not None else [
                terminals.goal_score_condition(),
                terminals.no_touch_condition(config.no_touch_timeout,
                                             config.step_seconds),
                terminals.timeout_condition(config.max_episode_seconds,
                                            config.step_seconds),
            ])
        self.state_setter = state_setter or state_setters.kickoff_state()
        self.event_config = event_config or eventsmod.EventConfig()
        self.num_actions = self.action_parser.num_actions
        self.obs_size = self.obs_builder.obs_size
        self.generator = torch.Generator(device=self.device)
        # the arenas this process steps; shard_train_state sets a block
        self.shard = EnvShard(config.num_envs)

    def _use_portable(self) -> bool:
        """The physics route (JAX env.py:120-143, :308-321): the kernel
        runs soccar, heatseeker and snowday on the procedural arena, the
        portable engine everything.  Asking for the kernel where it does
        not run raises; nothing swaps one route for the other."""
        backend = self.config.physics_backend
        if backend not in ("auto", "kernel", "portable"):
            raise ValueError(f"physics_backend={backend!r}: use 'auto', "
                             "'kernel' or 'portable'")
        mode = self.params.game_mode
        real_assets = self.params.use_mesh and not worldmod.is_procedural()
        if backend == "kernel":
            if mode not in GAME_MODES:
                raise ValueError(
                    f"the kernel route runs {GAME_MODES} (soccar geometry); "
                    f"use physics_backend='portable' for {mode}")
            if real_assets:
                raise ValueError(
                    "physics_backend='kernel' with use_mesh needs the "
                    "procedural arena (world.init(mesh_dir=None)); the "
                    "portable route collides against real .cmf assets")
        if backend == "auto":
            return mode not in GAME_MODES or real_assets
        return backend == "portable"

    # ------------------------------------------------------------------
    def _reset_states(self) -> EnvState:
        """Every arena's reset state, drawn at the global width; this
        rank's block of them."""
        P, shard = self.config.cars_per_arena, self.shard
        N = shard.local_envs
        dev = self.device
        phys = tree_map(shard.take, self.state_setter(
            self.generator, self.params, self.teams, shard.global_envs, dev))
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

    def reset(self, seed: int = 0):
        """Seed the env's generator and reset every arena.  Returns (state,
        obs (N, P, D), masks (N, P, A))."""
        self.generator.manual_seed(seed)
        state = self._reset_states()
        return state, self.obs(state), self.action_mask(state)

    @tracing.traced("env.physics")
    def physics_step(self, state: EnvState, controls: torch.Tensor):
        """Every arena through ``tick_skip`` ticks.  The kernel route takes
        one respawn-table draw per car per env step, the portable route
        one per car per tick (JAX step.py:699-700)."""
        cfg = self.config
        shape = (self.shard.global_envs, cfg.cars_per_arena)
        if self.portable:
            shape = (shape[0], cfg.tick_skip, shape[1])
        respawn_idx = self.shard.take(torch.randint(
            0, C.CAR_RESPAWN_LOCATION_AMOUNT, shape,
            generator=self.generator, device=self.device, dtype=torch.int32))
        if self.portable:
            return stepmod.arena_step(state.phys, controls, self.teams_np,
                                      respawn_idx, self.params,
                                      cfg.tick_skip, cfg.action_delay)
        return arena_step(state.phys, controls, respawn_idx, self.params,
                          self.teams_np, cfg.tick_skip, cfg.action_delay)

    def step(self, state: EnvState, action_idx: torch.Tensor):
        """``action_idx``: (N, P) int.  Returns (state, StepOutput)."""
        tracing.count("env.steps")
        with tracing.span("env.parse"):
            controls = self.action_parser.parse(action_idx)
        phys = self.physics_step(state, controls)
        return self.post_physics(state, phys, controls)

    @tracing.traced("env.post")
    def post_physics(self, state: EnvState, phys, controls):
        """Touch attribution, events, terminals, rewards, auto-reset, obs
        (env.py _post_physics_one of the JAX package, over all arenas)."""
        cfg = self.config
        arena = phys.arena
        with tracing.span("env.post.events"):
            tick = arena.tick_count
            touched = arena.cars.ball_hit_valid & (
                arena.cars.ball_hit_tick >= (tick - cfg.tick_skip)[:, None])
            tracker, ev = eventsmod.update_tracker(
                state.tracker, arena.cars, arena.ball, self.teams, tick,
                arena.goal_scored, cfg.tick_skip, self.params.mutators,
                self.event_config)
            ev = dict(ev, bump=arena.step_bump, bumped=arena.step_bumped,
                      demo=arena.step_demo, demoed=arena.step_demoed)

        with tracing.span("env.post.terminals"):
            steps_since_touch = torch.where(touched.any(-1), 0,
                                            state.steps_since_touch + 1)
            steps_since_reset = state.steps_since_reset + 1
            # goals counted from the ball's side (ExampleMain.cpp:46-124)
            blue_side = arena.ball.pos[:, 1] > 0
            blue_score = state.blue_score + (arena.goal_scored
                                             & blue_side).to(torch.int32)
            orange_score = state.orange_score + (
                arena.goal_scored & ~blue_side).to(torch.int32)
            terminal_type = self.terminal_fn(TerminalCtx(
                goal_scored=arena.goal_scored,
                steps_since_touch=steps_since_touch,
                steps_since_reset=steps_since_reset,
                blue_score=blue_score, orange_score=orange_score))

        with tracing.span("env.post.rewards"):
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
        with tracing.span("env.post.obs"):
            final_obs = self.obs(next_state)

        # auto-reset (EnvSet::Reset); every arena draws a reset state so
        # the step has no host sync, the terminal ones take it
        with tracing.span("env.post.reset_draw"):
            is_terminal = terminal_type != terminals.NOT_TERMINAL
            reset_state = self._reset_states()
            next_state = tree_map(
                lambda r, n: torch.where(
                    is_terminal.reshape((-1,) + (1,) * (n.dim() - 1)), r, n),
                reset_state, next_state)

        with tracing.span("env.post.obs"):
            obs = self.obs(next_state)
        with tracing.span("env.post.masks"):
            action_mask = self.action_mask(next_state)
        out = StepOutput(
            obs=obs, final_obs=final_obs, reward=reward,
            terminal_type=terminal_type, action_mask=action_mask,
            ball_touched=touched, goal_scored=arena.goal_scored,
            reward_components=components)
        return next_state, out
