"""The portable physics engine on the card, against the same code on the
CPU: the arena geometry, the portable env step, hoops and the ball
prediction.

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).

- the procedural soccar and hoops ``MeshGrid``s baked onto the card
  (``world.get_grid``) and kept; ``sphere_contacts`` for 1,024 balls,
  ``raycast`` for 1,024 x 4 x 4 wheel rays (every candidate, and the 12
  the portable engine keeps) and ``box_contacts`` for 4,096 car hitboxes,
  drawn from the states a full-fidelity collection stepped from;
  ``box_box_manifold`` on 4,096 overlapping car pairs; lengths within 4e-3
  uu over every candidate, live or not, box-box within 1e-4 bt, a flag
  differing in at most 0.1% of the rows and only within the length
  tolerance of its threshold;
- ``RocketLeagueEnv`` 1024 x 2v2 soccar with ``physics_backend="portable"``
  steps from that collection's end state with no kernel launch, and its
  ``arena_step`` on the card agrees with the CPU's on the same controls
  and per-tick respawn draws (``ops.ctick.TOLERANCES``, at most 2% of
  arenas with a differing flag or a float beyond them: contacts round
  differently on the card's libm);
- one ``train_iteration`` of 1024 x 2v2 hoops at the bench widths through
  ``physics_backend="auto"``: the portable route, no kernel launch;
- ``BallPredTracker(120)`` in hoops over the 1024 balls of that
  iteration's end state, card against CPU, at most 2% of balls off.
"""

from __future__ import annotations

import pytest
import torch

from bench_torch import bench_trainer
from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch import maths as m
from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.ops.ctick import TOLERANCES
from reinforcement_learning_torch.physics import box_box, world
from reinforcement_learning_torch.physics import step as stepmod
from reinforcement_learning_torch.physics.ball_pred import BallPredTracker
from reinforcement_learning_torch.physics.formulas import \
    box_effective_half_extents_bt
from reinforcement_learning_torch.physics.state import CarConfig
from reinforcement_learning_torch.utils import tracing
from torch_card import (BB_ATOL, CARS, GEOM_ATOL, PORTABLE_SHARE, SEED, T,
                        THRESHOLD_SHARE, E, card, check_metrics, check_traj,
                        close_where, collect_at_bench_width, compare,
                        counter, flags_agree, parameters)


@pytest.fixture(scope="module")
def full_collection(card):
    """A full-fidelity collection of 1024 x 2v2 at the bench widths: the
    positions its warm-up stepped from, and the state it ends in."""
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, device=card))
    return collect_at_bench_width(env, record=True)


# --- the arena geometry ----------------------------------------------------

@pytest.fixture(scope="module")
def grids(card):
    """mode -> (its MeshGrid on the card, the same on the CPU)."""
    out = {}
    for mode in ("soccar", "hoops"):
        world.init()
        grid = world.get_grid(mode, device=card)
        assert grid.tri_a.device.type == card
        assert world.get_grid(mode, device=card) is grid
        out[mode] = grid, grid.to("cpu")
    return out


@pytest.fixture(scope="module")
def queries(full_collection, card):
    """1,024 balls and 4,096 cars (hitbox centres, rotations, wheel rays)
    drawn from the positions the collection stepped from."""
    ball_pos, car_pos, car_rot = full_collection["positions"]
    pick = torch.Generator(device=card).manual_seed(SEED)
    balls = ball_pos[torch.randperm(len(ball_pos), generator=pick,
                                    device=card)[:E]]
    ci = torch.randperm(len(car_pos) * CARS, generator=pick,
                        device=card)[:E * CARS]
    cpos = car_pos.reshape(-1, 3)[ci]
    crot = car_rot.reshape(-1, 3, 3)[ci]
    cfg = CarConfig()
    he = torch.tensor(cfg.hitbox_size, device=card) / 2
    hit_c = cpos + m.rotate(crot, torch.tensor(cfg.hitbox_offset,
                                               device=card))
    starts = cpos[:, None] + torch.einsum(
        'nij,wj->nwi', crot, torch.tensor(cfg.wheel_offsets(), device=card))
    dirs = -crot[:, None, :, 2].expand_as(starts)
    # the wheel ray's length as the portable engine casts it (JAX
    # physics/car.py:152-157): rest + travel + radius - the subtraction
    ray_len = torch.tensor(
        cfg.sus_rest_lengths() + cfg.wheel_radii()
        + C.BTVehicle.MAX_SUSPENSION_TRAVEL
        - C.BTVehicle.SUSPENSION_SUBTRACTION * C.BT_TO_UU, device=card)
    return dict(balls=balls, crot=crot, cfg=cfg, he=he, hit_c=hit_c,
                starts=starts, dirs=dirs,
                ray_len=ray_len.expand(starts.shape[:-1]))


@pytest.mark.card
@pytest.mark.parametrize("mode", ["soccar", "hoops"])
def test_sphere_contacts(grids, queries, mode):
    # every candidate's depth, point and normal is compared, live or not
    grid, cpu = grids[mode]
    balls, r = queries["balls"], C.BALL_COLLISION_RADIUS_SOCCAR
    if mode == "hoops":
        balls = balls * torch.tensor(
            [C.ARENA_EXTENT_X_HOOPS / C.ARENA_EXTENT_X,
             C.ARENA_EXTENT_Y_HOOPS / C.ARENA_EXTENT_Y, 1.0],
            device=balls.device)
        r = C.BALL_COLLISION_RADIUS_HOOPS
    n, d, a = grid.sphere_contacts(balls, r)
    nc, dc, ac = cpu.sphere_contacts(balls.cpu(), r)
    flags_agree("sphere", a, ac, d)
    close_where("sphere depth", d, dc, GEOM_ATOL)
    if mode == "soccar":
        close_where("sphere normal x distance", n * (r - d)[..., None],
                    nc * (r - dc)[..., None], GEOM_ATOL)


@pytest.mark.card
@pytest.mark.parametrize("k_compact", [None, 12])
def test_raycast(grids, queries, k_compact):
    # every candidate, and the 12 the portable engine keeps by AABB overlap
    # (JAX contacts.py MESH_COMPACT_K_RAY, car.py:166-169)
    grid, cpu = grids["soccar"]
    starts, dirs, ray_len = (queries[k] for k in ("starts", "dirs",
                                                  "ray_len"))
    hit, rd, rn = grid.raycast(starts, dirs, ray_len, k_compact=k_compact)
    hc, rdc, rnc = cpu.raycast(starts.cpu(), dirs.cpu(), ray_len.cpu(),
                               k_compact=k_compact)
    both = flags_agree("raycast", hit, hc, rdc - ray_len.cpu())
    close_where("raycast distance", rd, rdc, GEOM_ATOL)
    close_where("raycast normal", rn, rnc, GEOM_ATOL, both)


@pytest.mark.card
def test_box_contacts(grids, queries):
    grid, cpu = grids["soccar"]
    hit_c, crot = queries["hit_c"], queries["crot"]
    hev = queries["he"].expand(hit_c.shape)
    bn, bp, bd, ba = grid.box_contacts(hit_c, crot, hev)
    bnc, bpc, bdc, bac = cpu.box_contacts(hit_c.cpu(), crot.cpu(), hev.cpu())
    # a box contact is live where it is deep enough and its support point
    # projects into the triangle: no one length decides it
    flags_agree("box", ba, bac)
    close_where("box depth", bd, bdc, GEOM_ATOL)
    close_where("box point", bp, bpc, GEOM_ATOL)
    close_where("box normal", bn, bnc, 1e-5)


@pytest.mark.card
def test_box_box_manifold(queries, card):
    """4,096 car pairs set to overlap, in bt units as the tick runs them."""
    gen = torch.Generator(device=card).manual_seed(SEED)
    he_bt = torch.tensor(box_effective_half_extents_bt(
        queries["cfg"].hitbox_size), dtype=torch.float32, device=card)
    p1 = queries["hit_c"] / C.BT_TO_UU
    off = (torch.rand(len(p1), 3, generator=gen, device=card) * 2 - 1) \
        * 1.8 * he_bt
    p2 = p1 + m.rotate(queries["crot"], off)
    q, rr = torch.linalg.qr(torch.randn(len(p1), 3, 3, generator=gen,
                                        device=card))
    q = q * torch.sign(torch.diagonal(rr, dim1=-2, dim2=-1))[:, None, :]
    q[torch.linalg.det(q) < 0, :, 0] *= -1
    args = (p1, queries["crot"], he_bt, p2, q, he_bt)
    mf = box_box.box_box_manifold(*args)
    mfc = box_box.box_box_manifold(*(x.cpu() for x in args))
    same = (mf["code"].cpu() == mfc["code"]) & (
        mf["active"].cpu() == mfc["active"]).all(-1)
    assert int((~same).sum()) <= THRESHOLD_SHARE * len(same) + 1
    act = mf["active"].cpu() & same[:, None]
    close_where("box-box depth", mf["depth"], mfc["depth"], BB_ATOL, act)
    close_where("box-box point", mf["points"], mfc["points"], BB_ATOL, act)
    close_where("box-box normal", mf["normal"], mfc["normal"], BB_ATOL, same)
    assert int(mf["overlap"].sum()) >= len(p1) // 2


# --- the portable engine ---------------------------------------------------

@pytest.mark.card
def test_portable_step_on_the_card_equals_the_cpu(full_collection, card):
    played = full_collection["state"].env_states
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2,
                                    physics_backend="portable",
                                    device=card))
    assert env.portable and env.params.use_mesh
    assert env.params.dynamic_wheel_rays
    gen = torch.Generator(device=card).manual_seed(SEED)
    actions = torch.randint(0, env.num_actions, (E, CARS), generator=gen,
                            device=card)
    controls = env.action_parser.parse(actions)
    r = torch.randint(0, 4, (E, 8, CARS), generator=gen, device=card,
                      dtype=torch.int32)
    tracing.reset()
    _, out = env.step(played, actions)
    assert counter("kernel.launches") == 0
    assert bool(torch.isfinite(out.obs).all())
    got = stepmod.arena_step(played.phys, controls, env.teams_np, r,
                             env.params)
    want = stepmod.arena_step(tree_map(lambda t: t.cpu(), played.phys),
                              controls.cpu(), env.teams_np, r.cpu(),
                              env.params)
    compare(got, tree_map(lambda t: t.to(card), want),
            int(PORTABLE_SHARE * E), floats_count=True)


@pytest.fixture(scope="module")
def hoops_run(card):
    """One hoops ``train_iteration`` at the bench widths, through
    ``physics_backend="auto"``, the kernel's launches counted."""
    trainer = bench_trainer(E, "hoops", SEED)
    seen = {}
    collect = trainer.collect

    def keep(*args, **kw):
        out = collect(*args, **kw)
        seen["traj"] = out[1]
        return out
    trainer.collect = keep
    before = parameters(trainer.learner)
    state = trainer.init(SEED)
    tracing.reset()
    state, metrics = trainer.train_iteration(state)
    del trainer.collect
    return dict(trainer=trainer, before=before, state=state,
                metrics=metrics, traj=seen["traj"],
                launches=counter("kernel.launches"))


@pytest.mark.card
def test_hoops_iteration_takes_the_portable_route(hoops_run):
    trainer = hoops_run["trainer"]
    env = trainer.env
    assert env.portable and env.config.physics_backend == "auto"
    assert trainer.steps_per_itr == T
    assert hoops_run["launches"] == 0
    check_metrics(hoops_run["metrics"], hoops_run["before"],
                  trainer.learner.parameters())
    check_traj(env, hoops_run["traj"], T)


@pytest.mark.card
def test_ball_prediction_on_the_card_equals_the_cpu(hoops_run):
    ball = hoops_run["state"].env_states.phys.ball
    got = BallPredTracker(120, game_mode="hoops").update(ball)
    want = BallPredTracker(120, game_mode="hoops").update(
        tree_map(lambda t: t.cpu(), ball))
    bad = torch.zeros(E, dtype=torch.bool)
    for k in ("pos", "vel", "ang_vel", "rot"):
        g, w = getattr(got, k).cpu(), getattr(want, k)
        assert tuple(g.shape[:2]) == (E, 120), k
        assert bool(torch.isfinite(g).all()), k
        atol, rtol = TOLERANCES[f"arena.ball.{k}"]
        bad |= ((g - w).abs() > atol + rtol * w.abs()).reshape(E, -1).any(-1)
    assert int(bad.sum()) <= int(PORTABLE_SHARE * E)
    # some ball fell under gravity
    assert bool((got.vel[:, 1:, 2] < got.vel[:, :-1, 2]).any())
