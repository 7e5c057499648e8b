"""The arena-step kernel's culls (csrc/facets.cuh), written in torch in
reinforcement_learning_torch/physics/facet_arena.py, held against the plain
facet queries: no band, goal rectangle or sheet that a cull rejects has a
live row for the body, or a hit for the ray, on batches near every kind of
surface (the batch makers of test_torch_facet_arena.py); and in midfield
the culls reject most bands.  Exact: a cull that rejected one live row
would fail.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch.physics import facet_arena as tfa
from test_torch_facet_arena import (BALL_R, HE, OFF, _rot_tuple, _rotmats,
                                    _surface_points, _t)

torch.set_num_threads(1)

NB = tfa.N_SIDES * tfa.N_PROFILE_BANDS
BRK = TC.CONTACT_BREAK_FRAC * (float(np.linalg.norm(HE))
                               + float(np.linalg.norm(OFF)))
BG = TC.CONTACT_BREAK_FRAC * (BALL_R + TC.SPHERE_BOUND_EXTRA)
HC = tuple(h - TC.MESH_COLLISION_MARGIN for h in HE)
DIST_M = tfa.box_dist_margin(HE)
RAY_LEN = 120.0


@pytest.fixture(scope="module")
def batch():
    """Points near every surface, and the same points pushed a random
    20-120 uu further along a random direction, with rotations."""
    rng = np.random.RandomState(7)
    p = _surface_points(rng)
    d = rng.normal(size=p.shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = np.concatenate([p, p + d * rng.uniform(20, 120, (len(p), 1))])
    return p.astype(np.float32), _rotmats(rng, len(p))


def _band_items(rows):
    """(NB, N): whether any of a band item's 4 row kinds is set."""
    B = tfa.N_PROFILE_BANDS
    out = torch.zeros((NB,) + rows.shape[1:], dtype=torch.bool)
    for side in range(tfa.N_SIDES):
        for kind in range(4):
            base = side * 4 * B + kind * B
            out[side * B:(side + 1) * B] |= rows[base:base + B]
    return out


def _check(culled, live, name, min_live):
    bad = culled & live
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} culled items have live rows, "
        f"first at {bad.nonzero()[:5].tolist()}")
    assert int(live.sum()) >= min_live, name     # the batch reaches them


def test_box_culls_keep_every_live_row(batch):
    p, R = batch
    px, py, pz = (_t(p[:, i]) for i in range(3))
    rot = _rot_tuple(R, "torch")
    active = tfa.box_contacts(px, py, pz, rot, HE, BRK)[7]
    _check(tfa.box_band_culled(px, py, pz, rot, HC, DIST_M, BRK),
           _band_items(active[:NB * 4]), "box bands", 80)
    _check(tfa.rect_culled("box", px, py, pz, BRK,
                           float(np.linalg.norm(HE))),
           active[NB * 4:], "box rectangles", 12)


def test_sphere_culls_keep_every_live_row(batch):
    p, _ = batch
    px, py, pz = (_t(p[:, i]) for i in range(3))
    active = tfa.sphere_contacts(px, py, pz, BALL_R, BG)[4]
    _check(tfa.sphere_band_culled(px, py, pz, BALL_R, BG),
           _band_items(active[:NB * 4]), "sphere bands", 200)
    rect_live = active[NB * 4::2] | active[NB * 4 + 1::2]
    _check(tfa.rect_culled("sphere", px, py, pz, BG, BALL_R), rect_live,
           "sphere rectangles", 20)


@pytest.mark.parametrize("sheet", ["floor", "ceiling"])
def test_sheet_culls_keep_every_live_row(batch, sheet):
    p, R = batch
    z0, up = (0.0, 1.0) if sheet == "floor" else (TC.ARENA_HEIGHT, -1.0)
    p = p.copy()
    p[:, 2] = z0 + up * np.random.RandomState(8).uniform(-5, 200, len(p))
    px, py, pz = (_t(p[:, i]) for i in range(3))
    rot = _rot_tuple(R, "torch")
    rows = tfa.sheet_box_contacts(px, py, pz, rot, HE, OFF, z0, up,
                                  TC.MESH_COLLISION_MARGIN, DIST_M, BRK)
    live = torch.stack([r[7] for r in rows]).any(0)
    cz = pz + rot[2][0] * OFF[0] + rot[2][1] * OFF[1] + rot[2][2] * OFF[2]
    _check(tfa.sheet_culled("box", cz, up, z0, BRK, DIST_M, rot, HC), live,
           f"{sheet} box", 50)
    rows = tfa.sheet_sphere_contacts(px, py, pz, BALL_R, BG, z0, up)
    live = torch.stack([r[6] for r in rows]).any(0)
    _check(tfa.sheet_culled("sphere", pz, up, z0, BG, BALL_R), live,
           f"{sheet} sphere", 20)


def test_ray_culls_keep_every_hit(batch):
    p, R = batch
    # the wheel rays (each box's -up) and random directions
    rng = np.random.RandomState(9)
    d2 = rng.normal(size=p.shape)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    d = np.concatenate([-R[:, :, 2], d2]).astype(np.float32)
    o = np.concatenate([p, p])
    ox, oy, oz = (_t(o[:, i]) for i in range(3))
    t_band, t_rect = tfa.ray_facet_hits(
        ox, oy, oz, *(_t(d[:, i]) for i in range(3)), RAY_LEN)
    _check(tfa.ray_band_culled(ox, oy, oz, RAY_LEN), torch.isfinite(t_band),
           "ray bands", 100)
    _check(tfa.rect_culled("ray", ox, oy, oz, RAY_LEN),
           torch.isfinite(t_rect), "ray rectangles", 10)


def test_culls_reject_most_bands_in_midfield():
    rng = np.random.RandomState(10)
    n = 400
    p = np.stack([rng.uniform(-2500, 2500, n), rng.uniform(-3500, 3500, n),
                  rng.uniform(17, 200, n)], -1).astype(np.float32)
    px, py, pz = (_t(p[:, i]) for i in range(3))
    rot = _rot_tuple(_rotmats(rng, n), "torch")
    shares = {
        "box": tfa.box_band_culled(px, py, pz, rot, HC, DIST_M, BRK),
        "sphere": tfa.sphere_band_culled(px, py, pz, BALL_R, BG),
        "ray": tfa.ray_band_culled(px, py, pz, 40.0)}
    for name, culled in shares.items():
        assert float(culled.float().mean()) > 0.95, name
