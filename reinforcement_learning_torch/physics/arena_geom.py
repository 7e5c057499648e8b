"""Analytic soccar arena: the half-space plane table the tick collides with.

Each plane is ``[nx, ny, nz, d]`` with signed distance ``n . p + d`` (> 0
inside the arena).  Conditional planes (back walls around the goal opening,
the goal box) get a validity mask from the query position; see
``ops/ctick.plane_validity``.
"""

from __future__ import annotations

import numpy as np

from reinforcement_learning_torch import constants as C

_SQ2 = 1.0 / np.sqrt(2.0)

_PLANES = np.array([
    [0, 0, 1, 0],                               # floor
    [0, 0, -1, C.ARENA_HEIGHT],                 # ceiling
    [1, 0, 0, C.ARENA_EXTENT_X],                # wall x = -4096
    [-1, 0, 0, C.ARENA_EXTENT_X],               # wall x = +4096
    [0, 1, 0, C.ARENA_EXTENT_Y],                # back wall y = -5120
    [0, -1, 0, C.ARENA_EXTENT_Y],               # back wall y = +5120
    [_SQ2, _SQ2, 0, C.ARENA_CORNER_INTERCEPT * _SQ2],    # corner -x -y
    [-_SQ2, _SQ2, 0, C.ARENA_CORNER_INTERCEPT * _SQ2],   # corner +x -y
    [_SQ2, -_SQ2, 0, C.ARENA_CORNER_INTERCEPT * _SQ2],   # corner -x +y
    [-_SQ2, -_SQ2, 0, C.ARENA_CORNER_INTERCEPT * _SQ2],  # corner +x +y
    # goal box (valid only when inside the goal opening / behind the wall)
    [1, 0, 0, C.GOAL_HALF_WIDTH],               # goal side x = -893
    [-1, 0, 0, C.GOAL_HALF_WIDTH],              # goal side x = +893
    [0, 0, -1, C.GOAL_HEIGHT],                  # goal ceiling
    [0, 1, 0, C.ARENA_EXTENT_Y + C.GOAL_DEPTH],   # net y = -6000
    [0, -1, 0, C.ARENA_EXTENT_Y + C.GOAL_DEPTH],  # net y = +6000
], dtype=np.float32)

NUM_PLANES = _PLANES.shape[0]

FLOOR, CEILING, WALL_XN, WALL_XP, WALL_YN, WALL_YP = range(6)
GOAL_XN, GOAL_XP, GOAL_CEIL, NET_YN, NET_YP = 10, 11, 12, 13, 14

# Real btStaticPlaneShapes in the reference arena (Arena.cpp:1060-1100):
# single support-vertex manifolds.  The rest stand in for triangle meshes.
_TRUE_PLANE = np.zeros(NUM_PLANES, bool)
_TRUE_PLANE[[FLOOR, CEILING, WALL_XN, WALL_XP]] = True
TRUE_PLANES = (FLOOR, CEILING, WALL_XN, WALL_XP)

# ---------------------------------------------------------------------------
# The procedural soccar mesh's profile (RocketSim.cpp:102-212): an octagonal
# plan whose walls sweep one vertical profile, a floor fillet arc, a straight
# section and a ceiling fillet arc.  physics/facet_arena.py derives its
# closed-form facet tables from these.

FLOOR_FILLET_RADIUS = 152.0    # floor -> wall transition ramp
CEILING_FILLET_RADIUS = 256.0  # wall -> ceiling transition ramp


def octagon_planes() -> np.ndarray:
    """The 8 outward wall planes of the soccar plan, as (nx, ny, d) with the
    wall surface at n.p = d, n pointing out of the arena."""
    s = 1.0 / np.sqrt(2.0)
    return np.array([
        [1, 0, C.ARENA_EXTENT_X],
        [s, s, C.ARENA_CORNER_INTERCEPT * s],
        [0, 1, C.ARENA_EXTENT_Y],
        [-s, s, C.ARENA_CORNER_INTERCEPT * s],
        [-1, 0, C.ARENA_EXTENT_X],
        [-s, -s, C.ARENA_CORNER_INTERCEPT * s],
        [0, -1, C.ARENA_EXTENT_Y],
        [s, -s, C.ARENA_CORNER_INTERCEPT * s],
    ], np.float64)


def z_samples(height: float, r_floor: float, r_ceil: float,
              n_fillet: int) -> np.ndarray:
    """The profile's z levels: arc-uniform along both fillets, plus mid
    height and GOAL_HEIGHT (where the goal-opening cut ends)."""
    th = np.linspace(0, np.pi / 2, n_fillet + 1)
    z_lo = r_floor * (1.0 - np.cos(th))
    z_hi = height - r_ceil * (1.0 - np.cos(th))
    mid = np.array([height * 0.5, C.GOAL_HEIGHT])
    return np.unique(np.concatenate([z_lo, np.sort(z_hi), mid]))
