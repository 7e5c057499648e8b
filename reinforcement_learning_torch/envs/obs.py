"""AdvancedObs (RLGymCPP/ObsBuilders/AdvancedObs.cpp:193-270), batched.

Ball (9) + previous action (8) + pads (34) + 29 floats per player, self
first, then teammates, then opponents: 167 floats for 2v2.  Orange players
see the world mirrored (x and y negated).  Pads are in the canonical rlgym
order (CommonValues.h:45-80), reversed for orange.
"""

from __future__ import annotations

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.device import resolve_device

POS_COEF = 1.0 / 2300.0
VEL_COEF = 1.0 / 2300.0
ANG_VEL_COEF = 1.0 / 5.5
BOOST_COEF = 0.01

# Canonical rlgym boost pad order (CommonValues.h:45-80)
_CANONICAL_PAD_LOCS = np.array([
    [0, -4240, 70], [-1792, -4184, 70], [1792, -4184, 70],
    [-3072, -4096, 73], [3072, -4096, 73], [-940, -3308, 70],
    [940, -3308, 70], [0, -2816, 70], [-3584, -2484, 70],
    [3584, -2484, 70], [-1788, -2300, 70], [1788, -2300, 70],
    [-2048, -1036, 70], [0, -1024, 70], [2048, -1036, 70],
    [-3584, 0, 73], [-1024, 0, 70], [1024, 0, 70], [3584, 0, 73],
    [-2048, 1036, 70], [0, 1024, 70], [2048, 1036, 70],
    [-1788, 2300, 70], [1788, 2300, 70], [-3584, 2484, 70],
    [3584, 2484, 70], [0, 2816, 70], [-940, 3310, 70], [940, 3308, 70],
    [-3072, 4096, 73], [3072, 4096, 73], [-1792, 4184, 70],
    [1792, 4184, 70], [0, 4240, 70],
], np.float32)


def _build_pad_permutation() -> np.ndarray:
    """perm[i] = arena-order index of canonical pad i (GameState.cpp
    _BuildBoostPadIndexMap; 2D distance < sqrt(10) match)."""
    arena = C.BOOST_PAD_LOCS_SOCCAR[:, :2]
    perm = np.zeros(C.NUM_BOOST_PADS, np.int64)
    for i, loc in enumerate(_CANONICAL_PAD_LOCS[:, :2]):
        d2 = np.sum((arena - loc) ** 2, axis=1)
        j = int(np.argmin(d2))
        assert d2[j] < 10.0, (i, d2[j])
        perm[i] = j
    assert len(set(perm.tolist())) == C.NUM_BOOST_PADS
    return perm


PAD_PERMUTATION = _build_pad_permutation()


def _invert_vec(v, inv):
    """Negate x and y where ``inv`` (broadcast against v[..., 0])."""
    flip = torch.tensor([-1.0, -1.0, 1.0], device=v.device)
    return torch.where(inv[..., None], v * flip, v)


class AdvancedObs:
    """AdvancedObs for every player of every arena, its tables on
    ``device`` (default ``"cuda"``)."""

    def __init__(self, num_players: int, teams: np.ndarray, device=None):
        self.num_players = num_players
        self.teams_np = np.asarray(teams)
        self.obs_size = 9 + 8 + C.NUM_BOOST_PADS + 29 * num_players
        # Static per-player ordering: self, teammates, opponents
        # (AdvancedObs.cpp:247-259)
        order = np.zeros((num_players, num_players), np.int64)
        for i in range(num_players):
            mates = [j for j in range(num_players)
                     if j != i and self.teams_np[j] == self.teams_np[i]]
            opps = [j for j in range(num_players)
                    if self.teams_np[j] != self.teams_np[i]]
            order[i] = [i] + mates + opps
        dev = resolve_device(device)
        self.order = torch.as_tensor(order.reshape(-1), device=dev)
        self.inv = torch.as_tensor(self.teams_np == 1, device=dev)
        self.inv_rep = self.inv.repeat_interleave(num_players)
        self.perm = torch.as_tensor(PAD_PERMUTATION, device=dev)

    def _player_block(self, cars, ball_pos, ball_vel, inv):
        """29 floats per (viewer, viewed) pair; ``cars`` fields (N, V, ...),
        ``ball_*`` (N, 1, 3), ``inv`` (V,) the viewer's mirroring."""
        pos = _invert_vec(cars.pos, inv)
        rot = cars.rot
        fwd = _invert_vec(rot[..., :, 0], inv)
        right = _invert_vec(rot[..., :, 1], inv)
        up = _invert_vec(rot[..., :, 2], inv)
        vel = _invert_vec(cars.vel, inv)
        ang = _invert_vec(cars.ang_vel, inv)
        bpos = _invert_vec(ball_pos.expand_as(pos), inv)
        bvel = _invert_vec(ball_vel.expand_as(pos), inv)

        def local(v):
            return torch.stack([m.dot(fwd, v), m.dot(right, v),
                                m.dot(up, v)], dim=-1)

        flags = torch.stack([
            cars.boost * BOOST_COEF,
            cars.is_on_ground.to(torch.float32),
            cars.has_flip_or_jump().to(torch.float32),
            cars.is_demoed.to(torch.float32),
            cars.has_jumped.to(torch.float32),
        ], dim=-1)
        return torch.cat([
            pos * POS_COEF, fwd, up, vel * VEL_COEF, ang * ANG_VEL_COEF,
            local(ang) * ANG_VEL_COEF, local(bpos - pos) * POS_COEF,
            local(bvel - vel) * VEL_COEF, flags], dim=-1)

    def build(self, cars, ball, pads, prev_actions):
        """cars: CarsState (N, P, ...); ball: BallState (N, ...); pads:
        PadsState (N, 34); prev_actions: (N, P, 8).  -> (N, P, obs)."""
        N, P = cars.boost.shape
        inv = self.inv
        bp = _invert_vec(ball.pos[:, None, :].expand(N, P, 3), inv)
        bv = _invert_vec(ball.vel[:, None, :].expand(N, P, 3), inv)
        ba = _invert_vec(ball.ang_vel[:, None, :].expand(N, P, 3), inv)
        ball_part = torch.cat([bp * POS_COEF, bv * VEL_COEF,
                               ba * ANG_VEL_COEF], dim=-1)

        act = pads.is_active[:, self.perm]
        cool = pads.cooldown[:, self.perm]
        inv_p = inv[None, :, None]
        act = torch.where(inv_p, act.flip(-1)[:, None], act[:, None])
        cool = torch.where(inv_p, cool.flip(-1)[:, None], cool[:, None])
        pad_vals = torch.where(act, 1.0, 1.0 / (1.0 + cool))

        gathered = _Gathered(cars, self.order)
        blocks = self._player_block(gathered, ball.pos[:, None, :],
                                    ball.vel[:, None, :], self.inv_rep)
        blocks = blocks.reshape(N, P, P * 29)
        return torch.cat([ball_part, prev_actions, pad_vals, blocks], dim=-1)


class _Gathered:
    """The CarsState fields the obs reads, gathered along the player axis."""

    def __init__(self, cars, idx):
        for name in ("pos", "rot", "vel", "ang_vel", "boost", "is_on_ground",
                     "is_demoed", "has_jumped"):
            setattr(self, name, getattr(cars, name)[:, idx])
        self._flip = cars.has_flip_or_jump()[:, idx]

    def has_flip_or_jump(self):
        return self._flip
