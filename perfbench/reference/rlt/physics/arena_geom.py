"""Analytic arena geometry: the half-space plane tables and their queries.

Each plane is ``[nx, ny, nz, d]`` with signed distance ``n . p + d`` (> 0
inside the arena).  Soccar (which heatseeker and snowday share) has the
floor, ceiling, side walls, back walls with the goal opening cut out, the
45-degree corner walls and the goal box; conditional planes (the back walls
around the goal opening, the goal box) get a validity mask from the query
position (``plane_validity``; the kernel route's twin is
``ops/ctick.plane_validity``).  Hoops is a rounded rectangle of solid walls
with 45-degree corners.  The queries take tensors with trailing xyz and
build the tables on the query's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt.device import resolve_device

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
CORNER0 = 6
GOAL_XN, GOAL_XP, GOAL_CEIL, NET_YN, NET_YP = 10, 11, 12, 13, 14

# Real btStaticPlaneShapes in the reference arena (Arena.cpp:1060-1100):
# single support-vertex manifolds.  The rest stand in for triangle meshes.
_TRUE_PLANE = np.zeros(NUM_PLANES, bool)
_TRUE_PLANE[[FLOOR, CEILING, WALL_XN, WALL_XP]] = True
TRUE_PLANES = (FLOOR, CEILING, WALL_XN, WALL_XP)

# The hoops arena ("Dunk House", RLConst.h:18-20): solid walls (no goal
# openings; scoring is positional, Arena.cpp:958-971), the rounded corners
# approximated by 45-degree cuts sized in proportion to soccar's.
HOOPS_CORNER_CUT = 1152.0 * (C.ARENA_EXTENT_X_HOOPS / C.ARENA_EXTENT_X)
HOOPS_CORNER_INTERCEPT = (C.ARENA_EXTENT_X_HOOPS + C.ARENA_EXTENT_Y_HOOPS
                          - HOOPS_CORNER_CUT)
_PLANES_HOOPS = np.array([
    [0, 0, 1, 0],
    [0, 0, -1, C.ARENA_HEIGHT_HOOPS],
    [1, 0, 0, C.ARENA_EXTENT_X_HOOPS],
    [-1, 0, 0, C.ARENA_EXTENT_X_HOOPS],
    [0, 1, 0, C.ARENA_EXTENT_Y_HOOPS],
    [0, -1, 0, C.ARENA_EXTENT_Y_HOOPS],
    [_SQ2, _SQ2, 0, HOOPS_CORNER_INTERCEPT * _SQ2],
    [-_SQ2, _SQ2, 0, HOOPS_CORNER_INTERCEPT * _SQ2],
    [_SQ2, -_SQ2, 0, HOOPS_CORNER_INTERCEPT * _SQ2],
    [-_SQ2, -_SQ2, 0, HOOPS_CORNER_INTERCEPT * _SQ2],
], dtype=np.float32)
# hoops adds real y-wall planes (Arena.cpp:1104-1117); the corners stand in
# for meshes
_TRUE_PLANE_HOOPS = np.zeros(_PLANES_HOOPS.shape[0], bool)
_TRUE_PLANE_HOOPS[:6] = True

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


# ---------------------------------------------------------------------------
# Queries

@functools.lru_cache(maxsize=None)
def _tables(mode: str, device: torch.device):
    planes, true = ((_PLANES_HOOPS, _TRUE_PLANE_HOOPS) if mode == "hoops"
                    else (_PLANES, _TRUE_PLANE))
    return (torch.as_tensor(planes[:, :3], device=device),
            torch.as_tensor(planes[:, 3], device=device),
            torch.as_tensor(true, device=device))


def get_true_plane_mask(mode: str = "soccar", device=None) -> torch.Tensor:
    """(P,) bool on ``device`` (default ``"cuda"``): which planes are real
    btStaticPlaneShapes in the reference (single support-point manifolds)
    and which stand in for meshes."""
    return _tables(mode, resolve_device(device))[2]


def get_planes(mode: str = "soccar", device=None):
    """(PLANE_N (P, 3), PLANE_D (P,)) of a game mode's arena on ``device``
    (default ``"cuda"``); soccar's also serve heatseeker and snowday, as the
    reference's mesh selection does."""
    return _tables(mode, resolve_device(device))[:2]


def plane_validity(pos: torch.Tensor, mode: str = "soccar") -> torch.Tensor:
    """(..., P) bool: which planes can act on a query at ``pos``.  The
    soccar back walls are cut out over the goal opening and the goal-box
    planes act only in or behind the goal; hoops planes always act."""
    if mode == "hoops":
        return torch.ones(pos.shape[:-1] + (_PLANES_HOOPS.shape[0],),
                          dtype=torch.bool, device=pos.device)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    in_goal_xz = (torch.abs(x) < C.GOAL_HALF_WIDTH) & (z < C.GOAL_HEIGHT)
    behind_wall = torch.abs(y) > C.ARENA_EXTENT_Y
    valid = torch.ones(pos.shape[:-1] + (NUM_PLANES,), dtype=torch.bool,
                       device=pos.device)
    valid[..., WALL_YN] = ~(in_goal_xz & (y < 0))
    valid[..., WALL_YP] = ~(in_goal_xz & (y > 0))
    valid[..., GOAL_XN] = behind_wall
    valid[..., GOAL_XP] = behind_wall
    valid[..., GOAL_CEIL] = behind_wall
    valid[..., NET_YN] = y < 0
    valid[..., NET_YP] = y > 0
    return valid


def signed_distances(pos: torch.Tensor, mode: str = "soccar"
                     ) -> torch.Tensor:
    """(..., P) signed distance of ``pos`` to each plane (> 0 inside)."""
    pn, pd = _tables(mode, pos.device)[:2]
    return torch.einsum('...i,pi->...p', pos, pn) + pd


def sphere_contacts(pos: torch.Tensor, radius: float, mode: str = "soccar"):
    """Sphere vs arena: (normal (..., P, 3), depth (..., P), active
    (..., P)), one contact per plane, touching where depth > 0."""
    pn = _tables(mode, pos.device)[0]
    dist = signed_distances(pos, mode)
    valid = plane_validity(pos, mode)
    depth = radius - dist
    active = valid & (depth > 0)
    return pn.expand(pos.shape[:-1] + pn.shape), depth, active


def box_support_radius(rot: torch.Tensor, half_extents: torch.Tensor
                       ) -> torch.Tensor:
    """(..., P): an oriented box's reach along each soccar plane normal,
    sum_i |h_i (n . axis_i)|."""
    pn = _tables("soccar", rot.device)[0]
    proj = torch.einsum('pi,...ij->...pj', pn, rot)
    return torch.sum(torch.abs(proj) * half_extents[..., None, :], dim=-1)


def box_contacts(pos: torch.Tensor, rot: torch.Tensor,
                 half_extents: torch.Tensor):
    """Oriented box vs the soccar planes, one contact per plane: (normal
    (..., P, 3), point (..., P, 3), depth (..., P), active (..., P)).  The
    point is the box's support point along -normal, where bullet's
    one-deepest-point manifold settles against a flat surface."""
    pn = _tables("soccar", pos.device)[0]
    dist = signed_distances(pos)
    valid = plane_validity(pos)
    depth = box_support_radius(rot, half_extents) - dist
    active = valid & (depth > 0)
    # support point: centre - sum_j sign(n . a_j) h_j a_j
    proj = torch.einsum('pi,...ij->...pj', pn, rot)
    offset = torch.einsum('...pj,...ij->...pi',
                          torch.sign(proj) * half_extents[..., None, :], rot)
    point = pos[..., None, :] - offset
    return pn.expand(dist.shape + (3,)), point, depth, active


def raycast_down_dir(start: torch.Tensor, direction: torch.Tensor, max_len,
                     mode: str = "soccar", true_planes_only: bool = False):
    """Ray vs the arena planes, as the reference's suspension raycast
    against the world (btVehicleRL.cpp:118-212).  start, direction (..., 3)
    (unit); max_len a scalar or (...,).  Returns (hit (...,), dist (...,),
    normal (..., 3)), dist = max_len without a hit.  ``true_planes_only``
    keeps the real btStaticPlaneShapes only (for when a MeshGrid supplies
    the mesh surfaces)."""
    pn, _, true = _tables(mode, start.device)
    dist_p = signed_distances(start, mode)
    valid = plane_validity(start, mode)
    if true_planes_only:
        valid = valid & true
    denom = -torch.einsum('...i,pi->...p', direction, pn)
    t = torch.where(denom > 1e-6, dist_p / torch.clamp(denom, min=1e-6),
                    torch.inf)
    t = torch.where(valid & (t >= 0), t, torch.inf)
    t_min = torch.amin(t, dim=-1)
    idx = torch.argmin(t, dim=-1)
    max_len = torch.as_tensor(max_len, dtype=t_min.dtype,
                              device=t_min.device)
    hit = t_min <= max_len
    return hit, torch.where(hit, t_min, max_len), pn[idx]


def is_ball_scored(ball_pos: torch.Tensor,
                   ball_radius: float = C.BALL_COLLISION_RADIUS_SOCCAR,
                   goal_threshold_y: float =
                   C.SOCCAR_GOAL_SCORE_BASE_THRESHOLD_Y) -> torch.Tensor:
    """Arena::IsBallScored, soccar (Arena.cpp:949-957)."""
    return torch.abs(ball_pos[..., 1]) > (goal_threshold_y + ball_radius)
