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
