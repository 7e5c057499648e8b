"""RLBot deployment agent: the tick-skip and action-delay state machine
around a deployed policy.

The reference plays a trained policy in the real game through a C++ RLBot
client that rebuilds a ``GameState`` from each game packet and infers every
``tick_skip`` ticks, applying the action after the training-time
``action_delay`` (src/RLBotClient.cpp:27-150, rlbot/CppPythonAgent.py).
``RLBotAdapter`` is that client on the Python side: it builds the obs from
packet data with the training obs builder and infers through the native
C++ runtime on the host (``from_npz``, no card needed on the game machine)
or an ``InferUnit`` on the card (``from_infer_unit``).

An RLBot python agent is then a thin shim::

    from rlbot.agents.base_agent import BaseAgent
    class Agent(BaseAgent):
        def initialize_agent(self):
            self.adapter = RLBotAdapter.from_npz(...)
        def get_output(self, packet):
            return SimpleControllerState(*self.adapter.get_output(...))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.envs.actions import DefaultAction
from reinforcement_learning_torch.envs.obs import PAD_PERMUTATION, AdvancedObs
from reinforcement_learning_torch.physics.state import (make_ball_state,
                                                        make_cars_state,
                                                        make_pads_state)


@dataclasses.dataclass
class PacketPlayer:
    pos: np.ndarray
    yaw: float
    pitch: float
    roll: float
    vel: np.ndarray
    ang_vel: np.ndarray
    boost: float
    team: int
    is_on_ground: bool = True
    has_jumped: bool = False
    is_demoed: bool = False


class RLBotAdapter:
    """The tick-skip / action-delay state machine around a deployed policy
    (RLBotBot::GetOutput, RLBotClient.cpp:94-139).  ``infer_fn(obs_row,
    mask_row) -> action index`` takes the obs builder's tensors."""

    def __init__(self, infer_fn, obs_builder: AdvancedObs,
                 action_parser: DefaultAction | None = None,
                 tick_skip: int = 8, action_delay: int = 7):
        self.infer_fn = infer_fn
        self.obs_builder = obs_builder
        self.device = obs_builder.order.device
        self.action_parser = action_parser or DefaultAction(
            device=self.device)
        self.tick_skip = tick_skip
        self.action_delay = action_delay
        self.ticks = -1
        self.prev_time = 0.0
        self.update_action = True
        self.controls = np.zeros(8, np.float32)
        self.pending_action = np.zeros(8, np.float32)

    @classmethod
    def from_npz(cls, npz_path: str, team_size: int, my_index: int,
                 **kwargs) -> "RLBotAdapter":
        """Inference by the native C++ runtime on the host (the obs built
        on the CPU), from a parameter ``.npz``; the runtime computes
        ReLU."""
        from reinforcement_learning_torch.deploy.native import NativePolicy
        from reinforcement_learning_torch.tools.checkpoint_converter import \
            load_npz_params
        teams = np.array([0] * team_size + [1] * team_size)
        obs_builder = AdvancedObs(2 * team_size, teams, device="cpu")
        parser = DefaultAction(device="cpu")
        policy = NativePolicy.from_params(load_npz_params(npz_path),
                                          obs_builder.obs_size,
                                          parser.num_actions)

        def infer(obs_row, mask_row):
            return int(policy.infer(obs_row[None].numpy(),
                                    mask_row[None].numpy(),
                                    deterministic=True)[0])

        adapter = cls(infer, obs_builder, parser, **kwargs)
        adapter.my_index = my_index
        return adapter

    @classmethod
    def from_infer_unit(cls, unit, my_index: int,
                        **kwargs) -> "RLBotAdapter":
        """Inference by an ``InferUnit`` on its device (the card by
        default), with its obs builder and action parser."""
        def infer(obs_row, mask_row):
            return int(unit.infer_actions(obs_row[None], mask_row[None])[0])

        adapter = cls(infer, unit.obs_builder, unit.action_parser, **kwargs)
        adapter.my_index = my_index
        return adapter

    def build_obs(self, ball_pos, ball_vel, ball_ang_vel, players,
                  pads_active, my_index: int):
        """The local player's (obs row, action mask row) from packet data,
        in the training AdvancedObs layout, on the obs builder's device.
        Timers the packet does not carry keep their defaults; the packet's
        pads arrive in the canonical order and go into arena order."""
        dev = self.device
        P = len(players)

        def f32(rows):
            return torch.tensor(np.asarray(rows, np.float32), device=dev)

        def flag(name):
            return torch.tensor([bool(getattr(p, name)) for p in players],
                                device=dev)[None]

        yaw, pitch, roll = (f32([getattr(p, k) for p in players])
                            for k in ("yaw", "pitch", "roll"))
        cars = make_cars_state(P, batch=(1,), device=dev)
        cars.pos = f32([p.pos for p in players])[None]
        cars.rot = m.euler_to_rotmat(yaw, pitch, roll)[None]
        cars.vel = f32([p.vel for p in players])[None]
        cars.ang_vel = f32([p.ang_vel for p in players])[None]
        cars.boost = f32([p.boost for p in players])[None]
        cars.is_on_ground = flag("is_on_ground")
        cars.has_jumped = flag("has_jumped")
        cars.is_demoed = flag("is_demoed")
        ball = make_ball_state(batch=(1,), device=dev)
        ball.pos = f32(ball_pos)[None]
        ball.vel = f32(ball_vel)[None]
        ball.ang_vel = f32(ball_ang_vel)[None]
        pads = make_pads_state(batch=(1,), device=dev)
        inv_perm = np.argsort(PAD_PERMUTATION)
        pads.is_active = torch.tensor(
            np.asarray(pads_active, bool)[inv_perm], device=dev)[None]

        prev_actions = torch.zeros(1, P, 8, device=dev)
        prev_actions[0, my_index] = f32(self.controls)
        obs = self.obs_builder.build(cars, ball, pads, prev_actions)
        mask = self.action_parser.action_mask(cars)
        return obs[0, my_index], mask[0, my_index]

    def get_output(self, seconds_elapsed: float, ball_pos, ball_vel,
                   ball_ang_vel, players, pads_active,
                   my_index: int) -> np.ndarray:
        """The per-game-tick entry (120 Hz): the 8 control floats."""
        delta = seconds_elapsed - self.prev_time
        self.prev_time = seconds_elapsed
        ticks_elapsed = int(round(delta * 120.0))
        if self.ticks >= 0:
            self.ticks += ticks_elapsed

        if self.update_action:
            self.update_action = False
            obs_row, mask_row = self.build_obs(
                ball_pos, ball_vel, ball_ang_vel, players, pads_active,
                my_index)
            idx = self.infer_fn(obs_row, mask_row)
            self.pending_action = self.action_parser.table_np[idx].copy()

        if self.ticks >= (self.action_delay - 1) or self.ticks == -1:
            self.controls = self.pending_action

        if self.ticks >= self.tick_skip or self.ticks == -1:
            self.ticks = 0
            self.update_action = True

        return self.controls
