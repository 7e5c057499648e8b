"""The work count behind the physics kernel's bound (ops/opcount.py): the
plain step it runs is the plain step, and the gated solvers count only
where their contact exists."""

from __future__ import annotations

import torch

from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.ops import arena_step as arena_step_mod
from reinforcement_learning_torch.ops import ctick, opcount
from reinforcement_learning_torch.physics import step as tstep

E, CARS, TEAMS = 2, 4, (0, 0, 1, 1)
TICKS = 2
FULL_FIDELITY_GATES = ("_facet_box_manifold", "_facet_sphere_manifold",
                       "sphere_contacts", "box_contacts",
                       "sheet_sphere_contacts", "sheet_box_contacts",
                       "keep_diverse4", "raycasts", "_pgs_rows")
CAR_FACET_GATES = ("_facet_box_manifold", "box_contacts", "raycasts",
                   "_pgs_rows")
GAME_MODE_GATES = ("_hs_steer", "_snow_plane_row")

torch.set_num_threads(1)


def _params():
    return tstep.ArenaParams(num_cars=CARS, use_mesh=False,
                             dynamic_wheel_rays=False)


def _state(overlap: bool):
    """Cars on the floor at the corners of a 4000 uu square, the ball at
    rest in the middle; with ``overlap`` car 2 stands 140 uu ahead of car
    0, hitboxes into each other, facing it."""
    phys = tstep.make_physics_state(_params(), batch=(E,), device="cpu")
    cars = phys.arena.cars
    cars.pos = torch.tensor([[-2000., -2000., 17.], [2000., -2000., 17.],
                             [-2000., 2000., 17.], [2000., 2000., 17.]]
                            ).expand(E, CARS, 3).clone()
    if overlap:
        cars.pos[:, 2] = cars.pos[:, 0] + torch.tensor([140., 5., 0.])
        cars.rot[:, 2] = torch.tensor([[-1., 0., 0.], [0., -1., 0.],
                                       [0., 0., 1.]])
        cars.vel[:, 0, 0] = 1200.0
    return phys


def _work(phys):
    ctl = torch.zeros(E, CARS, 8)
    ctl[..., 0] = 1.0
    ridx = torch.zeros(E, CARS, dtype=torch.int32)
    consts = arena_step_mod._consts(_params(), TEAMS)
    work = opcount.step_work(phys, ctl, ridx, consts, tick_skip=TICKS,
                             action_delay=0)
    want = ctick.arena_step_reference(phys, ctl, ridx, consts, TICKS, 0)
    total, _ = opcount.count_ops(lambda: ctick.arena_step_reference(
        phys, ctl, ridx, consts, TICKS, 0))
    return work, want, total


def test_step_work_runs_the_plain_step_and_restores_it():
    before = (ctick._pgs_pair, ctick._contact_vs_static)
    work, want, total = _work(_state(overlap=True))
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             work.out, want)
    assert (ctick._pgs_pair, ctick._contact_vs_static) == before
    assert work.ops_branch_free == total
    assert 0 < work.ops_needed < work.ops_branch_free
    for name, (needed, full) in work.by_gate.items():
        assert 0 <= needed <= full, name
        # the plane arena in soccar runs every gated solver but the
        # full-fidelity and game-mode ones
        assert (full > 0) == (name not in FULL_FIDELITY_GATES
                              + GAME_MODE_GATES), name


def test_gated_work_follows_the_contacts():
    apart, _, _ = _work(_state(overlap=False))
    touching, _, _ = _work(_state(overlap=True))
    for name in ("_pgs_pair", "_manifold", "_car_ball_rows"):
        assert apart.by_gate[name][0] == 0, name
    # one pair of six overlaps in every arena
    needed, full = touching.by_gate["_pgs_pair"]
    assert 0 < needed <= full / 6 + 1e-6 * full
    assert touching.by_gate["_manifold"][0] > 0
    assert touching.ops_needed > apart.ops_needed


def test_count_ops_counts_output_elements_of_arithmetic():
    a = torch.ones(3, 4)
    ops, calls = opcount.count_ops(lambda: torch.where(a > 0, a * 2 + 1, a))
    assert ops == 24           # mul and add; compare and select not counted
    assert calls == 4


def _mesh_work(phys):
    params = tstep.ArenaParams(num_cars=CARS)
    ctl = torch.zeros(E, CARS, 8)
    ridx = torch.zeros(E, CARS, dtype=torch.int32)
    consts = arena_step_mod._consts(params, TEAMS)
    return opcount.step_work(phys, ctl, ridx, consts, tick_skip=1,
                             action_delay=0)


def test_full_fidelity_gates_follow_the_facets():
    """At full fidelity each facet query, the facet raycast and the joint
    PGS count only where one of their own rows is live, and the retention
    on its live candidates: nothing for cars resting midfield; for the
    ball resting there the floor grid's rows and not the walls' or the
    goal's; on the x+ side wall, car 0 lying with its underside against it
    and car 1 standing on it on its wheels."""
    midfield = _state(overlap=False)
    apart = _mesh_work(midfield)
    for name in CAR_FACET_GATES + ("sheet_box_contacts",):
        needed, full = apart.by_gate[name]
        assert needed == 0 and full > 0, name
    # the resting ball touches the floor grid: its manifold is needed, but
    # only the grid's rows, and the retention for a few live candidates
    assert apart.by_gate["_facet_sphere_manifold"][0] > 0
    assert apart.by_gate["sheet_sphere_contacts"][0] > 0
    assert apart.by_gate["sphere_contacts"][0] == 0
    needed, full = apart.by_gate["keep_diverse4"]
    assert 0 < needed < full / 10
    walled = tree_map(lambda t: t.clone(), midfield)
    cars = walled.arena.cars
    cars.pos[:, 0] = torch.tensor([4099.0, -1000.0, 600.0])
    cars.pos[:, 1] = torch.tensor([4079.0, 1000.0, 600.0])
    cars.rot[:, :2] = torch.tensor([[0., 0., -1.], [0., 1., 0.],
                                    [1., 0., 0.]])      # up = -x
    near = _mesh_work(walled)
    for name in CAR_FACET_GATES:
        needed, full = near.by_gate[name]
        # at most two cars of four
        assert 0 < needed <= full / 2 + 1e-6 * full, name
    # 600 uu up, no car reaches the floor or ceiling grid
    assert near.by_gate["sheet_box_contacts"][0] == 0
    assert near.ops_needed > apart.ops_needed


def test_game_mode_gates_follow_their_events():
    """Heatseeker steering counts only where the ball seeks a goal; a
    snowday plane row only where it is live, the puck's 10-pass contact
    only where it touches (plane arena, 2 ticks)."""
    consts = {}
    works = {}
    ctl = torch.zeros(E, CARS, 8)
    ridx = torch.zeros(E, CARS, dtype=torch.int32)
    for mode in ("heatseeker", "snowday"):
        params = tstep.ArenaParams(num_cars=CARS, use_mesh=False,
                                   dynamic_wheel_rays=False, game_mode=mode)
        consts[mode] = arena_step_mod._consts(params, TEAMS)
        phys = _state(overlap=False)
        ball = phys.arena.ball
        ball.pos = torch.tensor([[0., 1000., 800.], [0., 1000., 31.5]])
        ball.vel = torch.tensor([[300., 900., 0.], [300., 900., -100.]])
        ball.hs_y_target_dir = torch.tensor([1.0, 0.0])
        works[mode] = opcount.step_work(phys, ctl, ridx, consts[mode],
                                        tick_skip=TICKS, action_delay=0)
    needed, full = works["heatseeker"].by_gate["_hs_steer"]
    assert 0 < needed and abs(needed - full / 2) < 1e-6 * full
    # arena 0's puck is in the air, arena 1's on the floor: one live row
    # (the floor) of 15 in one arena of 2
    needed, full = works["snowday"].by_gate["_snow_plane_row"]
    assert abs(needed - full / 30) < 1e-3 * full
    needed, full = works["snowday"].by_gate["_contact_vs_static"]
    assert 0 < needed < full
