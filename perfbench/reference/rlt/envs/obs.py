"""Observation builders (RLGymCPP/ObsBuilders/), batched: AdvancedObs
(AdvancedObs.cpp:193-270), DefaultObs and DefaultObsPadded.

AdvancedObs is ball (9) + previous action (8) + pads (34) + 29 floats per
player, self first, then teammates, then opponents: 167 floats for 2v2.
Orange players see the world mirrored (x and y negated).  Pads are in the
canonical rlgym order (CommonValues.h:45-80), reversed for orange.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt import maths as m
from perfbench.reference.rlt.device import resolve_device

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


def canonical_pads(values: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Arena-order pad values (N, pads) in canonical order (N, 34).  The
    permutation indexes soccar's 34 pads; only hoops, with 20, reaches the
    clamp: the JAX package's gather clamps an index past the last pad to
    it (XLA's out-of-range gather), so every canonical pad past 19 reads
    pad 19 there, and here too."""
    return values[:, torch.clamp(perm, max=values.shape[-1] - 1)]


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

        act = canonical_pads(pads.is_active, self.perm)
        cool = canonical_pads(pads.cooldown, self.perm)
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


def _player_order(teams: np.ndarray) -> np.ndarray:
    """(P, P): for each viewer, itself, then its teammates, then its
    opponents (AdvancedObs.cpp:247-259, DefaultObs.cpp:4-54)."""
    P = len(teams)
    order = np.zeros((P, P), np.int64)
    for i in range(P):
        mates = [j for j in range(P) if j != i and teams[j] == teams[i]]
        opps = [j for j in range(P) if teams[j] != teams[i]]
        order[i] = [i] + mates + opps
    return order


class DefaultObs:
    """DefaultObs (DefaultObs.cpp:4-54): ball (9) + previous action (8) +
    pads (34, 1 where active) + 19 floats per player (position, forward,
    up, velocity, angular velocity, boost, on ground, has flip, demoed),
    self first, then teammates, then opponents."""

    PLAYER_SIZE = 19

    def __init__(self, num_players: int, teams: np.ndarray, device=None):
        self.num_players = num_players
        self.teams_np = np.asarray(teams)
        self.obs_size = 9 + 8 + C.NUM_BOOST_PADS \
            + self.PLAYER_SIZE * num_players
        dev = resolve_device(device)
        self.order = torch.as_tensor(
            _player_order(self.teams_np).reshape(-1), device=dev)
        self.inv = torch.as_tensor(self.teams_np == 1, device=dev)
        self.inv_rep = self.inv.repeat_interleave(num_players)
        self.perm = torch.as_tensor(PAD_PERMUTATION, device=dev)

    def _player_block(self, cars, inv):
        """19 floats per (viewer, viewed) pair of ``cars`` (N, V, ...)
        gathered, with the viewer's mirroring ``inv`` (V,)."""
        rot = cars.rot
        flags = torch.stack([
            cars.boost / 100.0,
            cars.is_on_ground.to(torch.float32),
            cars.has_flip_or_jump().to(torch.float32),
            cars.is_demoed.to(torch.float32),
        ], dim=-1)
        return torch.cat([
            _invert_vec(cars.pos, inv) * POS_COEF,
            _invert_vec(rot[..., :, 0], inv), _invert_vec(rot[..., :, 2], inv),
            _invert_vec(cars.vel, inv) * VEL_COEF,
            _invert_vec(cars.ang_vel, inv) * ANG_VEL_COEF, flags], dim=-1)

    def _head(self, ball, pads, prev_actions):
        """Ball, previous action and pads: (N, P, 51)."""
        N, P = prev_actions.shape[:2]
        inv = self.inv
        parts = [_invert_vec(v[:, None, :].expand(N, P, 3), inv) * coef
                 for v, coef in ((ball.pos, POS_COEF), (ball.vel, VEL_COEF),
                                 (ball.ang_vel, ANG_VEL_COEF))]
        act = canonical_pads(pads.is_active, self.perm)
        act = torch.where(inv[None, :, None], act.flip(-1)[:, None],
                          act[:, None])
        return torch.cat(parts + [prev_actions, act.to(torch.float32)],
                         dim=-1)

    def _blocks(self, cars):
        """(N, P, P, 19): viewer, viewed in the viewer's order."""
        N, P = cars.boost.shape
        blocks = self._player_block(_Gathered(cars, self.order),
                                    self.inv_rep)
        return blocks.reshape(N, P, P, self.PLAYER_SIZE)

    def build(self, cars, ball, pads, prev_actions):
        """cars: CarsState (N, P, ...); ball: BallState (N, ...); pads:
        PadsState (N, 34); prev_actions: (N, P, 8).  -> (N, P, obs)."""
        N, P = cars.boost.shape
        return torch.cat([self._head(ball, pads, prev_actions),
                          self._blocks(cars).reshape(N, P, -1)], dim=-1)


class DefaultObsPadded(DefaultObs):
    """DefaultObsPadded (DefaultObsPadded.cpp:4-80): the teammate and
    opponent blocks padded with zero blocks to ``max_players`` per team,
    so the size does not depend on the team size.  ``build(...,
    perms=(mate_perm, opp_perm))`` shuffles the padded teammate and
    opponent slots by those permutations, one for every viewer, as the
    JAX package does when given a key; the env builds without."""

    def __init__(self, num_players: int, teams: np.ndarray,
                 max_players: int, device=None):
        super().__init__(num_players, teams, device)
        self.max_players = max_players
        self.obs_size = 9 + 8 + C.NUM_BOOST_PADS \
            + self.PLAYER_SIZE * (2 * max_players)

    def build(self, cars, ball, pads, prev_actions, perms=None):
        N, P = cars.boost.shape
        M = self.max_players
        blocks = self._blocks(cars)
        n_mates = P // 2 - 1 if P > 1 else 0
        mates = blocks[:, :, 1:1 + n_mates]
        opps = blocks[:, :, 1 + n_mates:]

        def pad_group(group, target):
            missing = target - group.shape[2]
            if missing > 0:
                group = torch.cat([group, group.new_zeros(
                    N, P, missing, self.PLAYER_SIZE)], dim=2)
            return group

        mates, opps = pad_group(mates, M - 1), pad_group(opps, M)
        if perms is not None:
            mates, opps = mates[:, :, perms[0]], opps[:, :, perms[1]]
        return torch.cat([self._head(ball, pads, prev_actions),
                          blocks[:, :, 0], mates.reshape(N, P, -1),
                          opps.reshape(N, P, -1)], dim=-1)
