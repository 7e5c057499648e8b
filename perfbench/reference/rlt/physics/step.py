"""The state containers and the static arena configuration of the port's
``physics/step.py``, copied as they were when the benchmark was written.
The portable engine that file also holds is not part of the reference:
the reference steps arenas with ``ops/ctick.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.rlt.device import resolve_device
from perfbench.reference.rlt.physics.state import WheelControlsState
from perfbench.reference.rlt.physics.state import (
    ArenaState, CarConfig, MutatorConfig, make_arena_state)


@dataclasses.dataclass
class PhysicsState:
    """ArenaState plus the cross-tick wheel drive state."""
    arena: ArenaState
    wheels: WheelControlsState

    @property
    def cars(self):
        return self.arena.cars

    @property
    def ball(self):
        return self.arena.ball


@dataclasses.dataclass(frozen=True)
class ArenaParams:
    """Static arena configuration.

    ``use_mesh`` (collide against the arena's triangle mesh: on the kernel
    route the procedural mesh as the closed-form facet arena, on the
    portable route the ``world.get_grid`` mesh) and ``dynamic_wheel_rays``
    (wheel rays also hit the ball and other cars) default to the
    reference's full fidelity; with both off the arena is analytic
    planes."""
    num_cars: int
    mutators: MutatorConfig = None
    car_config: CarConfig = CarConfig()
    tick_rate: float = 120.0
    game_mode: str = "soccar"
    use_mesh: bool = True
    dynamic_wheel_rays: bool = True

    def __post_init__(self):
        if self.mutators is None:
            object.__setattr__(self, "mutators",
                               MutatorConfig.for_mode(self.game_mode))

    @property
    def dt(self) -> float:
        return 1.0 / self.tick_rate


def make_physics_state(params: ArenaParams, batch=(),
                       device=None) -> PhysicsState:
    """Default state of one arena, or of ``batch`` arenas, on ``device``
    (default ``"cuda"``)."""
    device = resolve_device(device)
    return PhysicsState(
        arena=make_arena_state(params.num_cars, params.mutators,
                               params.game_mode, batch, device),
        wheels=WheelControlsState.make(params.num_cars, batch, device))


def clamp_controls(controls: torch.Tensor) -> torch.Tensor:
    """CarControls::ClampFix (CarControls.h:26-32) + booleanized buttons."""
    analog = torch.clamp(controls[..., :5], -1.0, 1.0)
    buttons = (controls[..., 5:] > 0).to(controls.dtype)
    return torch.cat([analog, buttons], dim=-1)


