"""Discrete action parser: the reference's 90-entry lookup table with
ground/air/jump/boost masks (RLGymCPP/ActionParsers/DefaultAction.cpp).

Action float layout: [throttle, steer, pitch, yaw, roll, jump, boost,
handbrake] (same as the physics controls).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.rlt.device import resolve_device


def _build_default_action_table():
    actions = []
    R_B = (0.0, 1.0)
    R_F = (-1.0, 0.0, 1.0)

    # Ground actions (DefaultAction.cpp:12-29)
    for throttle in R_F:
        for steer in R_F:
            for boost in R_B:
                for handbrake in R_B:
                    if boost == 1 and throttle != 1:
                        continue
                    actions.append([throttle, steer, 0, steer, 0, 0, boost,
                                    handbrake])
    num_ground = len(actions)

    # Aerial actions (DefaultAction.cpp:33-58)
    for pitch in R_F:
        for yaw in R_F:
            for roll in R_F:
                for jump in R_B:
                    for boost in R_B:
                        if jump == 1 and yaw != 0:
                            continue
                        if pitch == roll and roll == jump and jump == 0:
                            continue
                        handbrake = float(
                            jump == 1 and (pitch != 0 or yaw != 0
                                           or roll != 0))
                        actions.append([boost, yaw, pitch, yaw, roll, jump,
                                        boost, handbrake])

    table = np.array(actions, np.float32)
    n = len(actions)

    jump_mask = table[:, 5] > 0
    boost_mask = table[:, 6] > 0
    ground_mask = np.arange(n) < num_ground
    # strictly '>': index num_ground is excluded, as in the reference
    # (DefaultAction.cpp:80)
    air_mask = (np.arange(n) > num_ground) & ~jump_mask
    # Yaw-only ground actions are also allowed in the air (:84-89)
    for i in range(num_ground):
        a = table[i]
        if a[0] == a[6] and (a[3] != 0) == (a[7] != 0):
            air_mask[i] = True

    return table, ground_mask, air_mask, jump_mask, boost_mask, num_ground


class DefaultAction:
    """90-action discrete parser, its tables on ``device`` (default
    ``"cuda"``)."""

    def __init__(self, device=None):
        (table, ground, air, jump, boost, num_ground) = \
            _build_default_action_table()
        self.table_np = table
        self.num_actions = table.shape[0]
        self.num_ground = num_ground
        dev = resolve_device(device)
        self.table = torch.as_tensor(table, device=dev)
        self.ground_mask = torch.as_tensor(ground, device=dev)
        self.air_mask = torch.as_tensor(air, device=dev)
        self.jump_mask = torch.as_tensor(jump, device=dev)
        self.boost_mask = torch.as_tensor(boost, device=dev)

    def parse(self, action_indices: torch.Tensor) -> torch.Tensor:
        """(...,) int -> (..., 8) control floats."""
        return self.table[action_indices.long()]

    def action_mask(self, cars) -> torch.Tensor:
        """Per-player masks (DefaultAction.cpp:91-118).  ``cars``: a
        CarsState with leading axes (..., P).  Returns (..., P, A) bool."""
        on_ground = cars.is_on_ground[..., None]
        base = torch.where(on_ground, self.ground_mask, self.air_mask)
        no_boost = (cars.boost == 0)[..., None]
        base = base & ~(no_boost & self.boost_mask)
        turtled = cars.has_world_contact & (
            cars.world_contact_normal[..., 2] > 0.9)
        can_jump = (cars.has_flip_or_jump() | turtled)[..., None]
        return base | (can_jump & self.jump_mask)
