"""Cross-tick wheel drive state (btVehicleRL).

The reference computes this tick's friction impulses from the wheel
engine/brake/steer/friction values of the PREVIOUS tick
(updateVehicleFirst runs before _UpdateWheels, Car.cpp:90 vs :109), so those
values persist between ticks here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WheelControlsState:
    steer_angle: torch.Tensor    # (C,) front-wheel steering angle
    engine_force: torch.Tensor   # (C,) BT units
    brake: torch.Tensor          # (C,) BT units
    lat_friction: torch.Tensor   # (C, 4)
    long_friction: torch.Tensor  # (C, 4)

    @staticmethod
    def make(num_cars: int, batch=(), device=None) -> "WheelControlsState":
        z = lambda *s: torch.zeros(tuple(batch) + (num_cars,) + s,
                                   device=device)
        # btWheelInfoRL starts m_latFriction/m_longFriction at zero
        # (btVehicleRL.h:16)
        return WheelControlsState(steer_angle=z(), engine_force=z(),
                                  brake=z(), lat_friction=z(4),
                                  long_friction=z(4))
