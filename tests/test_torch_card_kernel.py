"""The physics kernel (``csrc/arena_step.cu``) against its plain PyTorch
version (``ops/ctick.py``) on the card, one env step at E=1024 x 4 cars
from crafted states.

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).  Each case checks that its state drove the contact or event it
was built for, read from the kernel's next state or from the plain step's
live facet candidates, wheel-ray ground bodies or snowday puck contacts,
where no true plane can stand in; then every float within
``ops.ctick.TOLERANCES``, with at most one arena (0.1%) allowed a
differing flag, integer or event timer in a random state and none in the
demo, car-car and game-mode states.

- the build: nvcc's ptxas lines of the 4- and 6-car kernels, and the
  launch shape;
- the plane arena (``use_mesh=False``, ``dynamic_wheel_rays=False``), from
  a state 6 random env steps after kickoff: that state, demolished cars
  respawning, opposing cars overlapping (bumps and demos), a car driving
  into the ball, the ball and a car flying into the walls;
- full fidelity (the facet arena and dynamic wheel rays): the ball into a
  floor fillet, a car driving up a back wall, a car flying side first into
  a back wall, the ball into a corner seam (more than 8 live candidates:
  the kernel's retention buffer overflows), into the goal's net and
  crossbar, a car dropped on the ball, a car dropped on another's roof;
- the game modes, each event in at least 90% of arenas: the heatseeker
  ball steering untouched, both teams first touching it in one tick, a
  back-wall hit flipping its target (full fidelity and the plane arena),
  the snowday puck on the floor and into a wall.
"""

from __future__ import annotations

import re

import pytest
import torch

from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.ops import ctick, cvec, pack
from reinforcement_learning_torch.physics.step import ArenaParams
from torch_card import (CARS, E, SEED, THRESHOLD_SHARE, States, card,
                        compare, kernel_and_plain, played, random_controls,
                        respawn_draws)

ONE = int(THRESHOLD_SHARE * E)     # arenas allowed a flipped flag


@pytest.mark.card
def test_build_reports_every_kernel(card):
    _, log = A.build(verbose=True)
    lines = log.splitlines()
    for num_cars in (4, 6):
        at = [i for i, ln in enumerate(lines)
              if "entry function" in ln and f"ILi{num_cars}E" in ln]
        assert at, f"no ptxas lines for the {num_cars}-car kernel"
        info = " ".join(lines[at[0] + 1:at[0] + 4])
        for k in ("registers", "bytes stack frame", "bytes spill stores",
                  "bytes spill loads"):
            assert re.search(rf"(\d+) {k}", info), (k, info)
    shape = A.launch_shape(A._library(), E, CARS)
    assert shape["threads_per_block"] == (shape["lanes_per_arena"]
                                          * shape["arenas_per_block"])
    assert shape["blocks"] == -(-E // shape["arenas_per_block"])


# --- the plane arena -------------------------------------------------------

PLANE = ArenaParams(num_cars=CARS, use_mesh=False, dynamic_wheel_rays=False)


@pytest.fixture(scope="module")
def plane_env(card):
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, arena=PLANE,
                                    device=card))
    gen = torch.Generator(device=card).manual_seed(SEED)
    return env, played(env, SEED, gen).phys


def respawned(env, phys, got, live):
    assert int((~got.arena.cars.is_demoed[:, 0]).sum()) > 0, (
        "no car respawned")


def demoed(env, phys, got, live):
    assert bool(got.arena.step_demo.any()), "no demo"


def ball_hit(env, phys, got, live):
    assert int((got.arena.ball.vel.norm(dim=-1) > 0).sum()) > 0, (
        "the resting ball was hit nowhere")


def walled(env, phys, got, live):
    along = (torch.arange(E, device=phys.arena.ball.vel.device) % 2)[:, None]
    bounced = int((phys.arena.ball.vel.gather(1, along)
                   * got.arena.ball.vel.gather(1, along) < 0).sum())
    hit = int((got.arena.cars.world_contact_normal[:, 1, 0].abs()
               > 0.5).sum())
    assert bounced and hit, (f"the ball bounced off a wall in {bounced} "
                             f"arenas, car 1 met a side wall in {hit}")


PLANE_CASES = {"random_steps": (None, ONE, None),
               "demo_respawn": ("demo_respawn", 0, respawned),
               "car_car": ("car_car", 0, demoed),
               "car_ball": ("car_ball", ONE, ball_hit),
               "walls": ("walls", ONE, walled)}


@pytest.mark.card
@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_plane_kernel_equals_plain(plane_env, case, card):
    env, base = plane_env
    craft, allowed, drove = PLANE_CASES[case]
    gen = torch.Generator(device=card).manual_seed(SEED)
    phys = getattr(States(gen), craft)(base) if craft else base
    got, live = kernel_and_plain(phys, random_controls(gen),
                                 respawn_draws(gen), PLANE, env.teams_np)
    if drove is not None:
        drove(env, phys, got, live)
    compare(got, live.want, allowed)


# --- full fidelity ---------------------------------------------------------

@pytest.fixture(scope="module")
def full_env(card):
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2, device=card))
    assert env.params.use_mesh and env.params.dynamic_wheel_rays
    gen = torch.Generator(device=card).manual_seed(SEED)
    return env, played(env, SEED + 1, gen).phys


def at_least_half(what, n):
    assert n >= E // 2, f"{what} in {n} of {E} arenas"


def fillet_bounced(env, phys, got, live):
    # falling at least 28 uu above the floor, the ball can turn both up and
    # back only off the fillet's curved facets: the floor does not reach it
    # and the side wall's plane has no z component
    vin, vout = phys.arena.ball.vel, got.arena.ball.vel
    up_back = (vout[:, 2] > 0) & (vout[:, 0] * vin[:, 0] < 0)
    at_least_half("the ball bounced up and back", int(up_back.sum()))
    at_least_half("a facet slot occupied", int((live.ball > 0).sum()))


def ground_of(phys, car, params, teams):
    """(4, E): the body each wheel ray of ``car`` stands on, by the plain
    version's raycast of ``phys`` (-1 world or none, -2 the ball, j car
    j)."""
    consts = A._consts(params, tuple(int(t) for t in teams))
    st = pack.to_components(phys)
    iw = cvec.inv_inertia_world(st["rot"], consts.inv_i_local)
    rc = ctick._wheel_raycasts(consts, st, iw)
    return torch.stack(rc["ground_idx"])[:, car]


def on_wall(env, phys, got, live):
    # no true plane has a y component: only the facet raycast holds the
    # wheels on a back wall
    cars = got.arena.cars
    wc = cars.wheels_with_contact[:, 1].all(-1)
    high = (cars.pos[:, 1, 1].abs() > 4950) & (cars.pos[:, 1, 2] > 300)
    at_least_half("car 1 on 4 wheels high on a back wall",
                  int((wc & high).sum()))


def box_walled(env, phys, got, live):
    # the world contact normal is the mean of the live rows' normals; no
    # true plane has a y component, so one pointing off the back wall came
    # from the facet box manifold
    sy = torch.sign(phys.arena.cars.pos[:, 2, 1])
    n = got.arena.cars.world_contact_normal[:, 2]
    at_least_half("car 2's hitbox met a back wall's facets",
                  int((n[:, 1] * sy < -0.5).sum()))
    at_least_half("a facet slot of car 2 occupied",
                  int((live.cars[2] > 0).sum()))


def overflowed(env, phys, got, live):
    # the kernel's retention replays a buffer of 8 live candidates and
    # enumerates them again when there are more
    at_least_half("a facet slot occupied", int((live.ball > 0).sum()))
    many = int((live.ball > 8).sum())
    assert many >= E // 8, f"more than 8 live candidates in {many} arenas"


def netted(env, phys, got, live):
    # no true plane has a y component: only the facets (back net, back
    # wall, crossbar) turn the ball back along y
    back = phys.arena.ball.vel[:, 1] * got.arena.ball.vel[:, 1] < 0
    at_least_half("the ball came back off the net or crossbar",
                  int(back.sum()))
    at_least_half("a facet slot occupied", int((live.ball > 0).sum()))


def on_ball(env, phys, got, live):
    cars = got.arena.cars
    # 200 uu up, only the ball is within the wheel rays' reach
    stand = cars.wheels_with_contact[:, 0].any(-1) & (cars.pos[:, 0, 2]
                                                      > 150)
    on = (ground_of(phys, 0, env.params, env.teams_np) == -2).any(0)
    at_least_half("car 0's wheels stand on the ball", int(stand.sum()))
    at_least_half("a wheel ray's ground body is the ball", int(on.sum()))


def on_roof(env, phys, got, live):
    cars = got.arena.cars
    # 75-85 uu up, only car 0's roof is within the wheel rays' reach
    stand = cars.wheels_with_contact[:, 1].any(-1) & (cars.pos[:, 1, 2]
                                                      > 60)
    on = (ground_of(phys, 1, env.params, env.teams_np) == 0).any(0)
    at_least_half("car 1's wheels stand on car 0's roof", int(stand.sum()))
    at_least_half("a wheel ray's ground body is car 0", int(on.sum()))


def still(card):
    return torch.zeros(E, CARS, 8, device=card)


def drive_car_1(card):
    ctl = still(card)
    ctl[:, 1, 0] = 1.0
    return ctl


# case -> (controls, check); None: random controls
FULL_CASES = {"fillet_ball": (None, fillet_bounced),
              "wall_drive": (drive_car_1, on_wall),
              "box_wall": (still, box_walled),
              "corner_ball": (None, overflowed),
              "goal_mouth": (None, netted),
              "car_on_ball": (still, on_ball),
              "car_on_car": (still, on_roof)}


@pytest.mark.card
@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_fidelity_kernel_equals_plain(full_env, case, card):
    env, base = full_env
    controls, check = FULL_CASES[case]
    gen = torch.Generator(device=card).manual_seed(SEED)
    S = States(gen)
    if case == "box_wall":
        consts = A._consts(env.params, tuple(int(t) for t in env.teams_np))
        phys = S.box_wall(base, consts.half_extents[1])
    else:
        phys = getattr(S, case)(base)
    ctl = random_controls(gen) if controls is None else controls(card)
    got, live = kernel_and_plain(phys, ctl, respawn_draws(gen), env.params,
                                 env.teams_np)
    check(env, phys, got, live)
    compare(got, live.want, ONE)


# --- game modes ------------------------------------------------------------

@pytest.fixture(scope="module")
def mode_envs(card):
    """mode -> (env at full fidelity, a state 6 random env steps after
    kickoff)."""
    out = {}
    for mode, seed in (("heatseeker", SEED + 2), ("snowday", SEED + 3)):
        env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=2,
                                        game_mode=mode, device=card))
        assert env.params.use_mesh
        gen = torch.Generator(device=card).manual_seed(SEED)
        out[mode] = env, played(env, seed, gen).phys
    return out


def event(what, mask):
    n = int(mask.sum())
    assert float(mask.float().mean()) >= 0.9, (
        f"{what} in only {n} of {E} arenas (90% needed)")


def touched(phys, out):
    """(E, C): the car touched the ball during the step."""
    cars = out.arena.cars
    return cars.ball_hit_valid & (cars.ball_hit_tick
                                  >= phys.arena.tick_count[:, None])


def steered(env, phys, got, live):
    ball, want = phys.arena.ball, live.want.arena.ball
    ran = (want.hs_time_since_hit - ball.hs_time_since_hit
           - 8 / 120.0).abs() < 1e-4
    event("the ball steered every tick, untouched",
          ran & ~touched(phys, live.want).any(-1))


def both_touched(env, phys, got, live):
    # the plain step's first tick: car 0 (blue) and car 2 (orange) both
    # touch the ball, the state's touches being older
    dev = phys.arena.tick_count.device
    consts = A._consts(env.params, tuple(int(t) for t in env.teams_np))
    one = ctick.arena_step_reference(
        phys, torch.zeros(E, CARS, 8, device=dev),
        torch.zeros(E, CARS, dtype=torch.int32, device=dev), consts, 1, 0)
    c1 = one.arena.cars
    event("both teams first touched the ball in the same tick",
          (c1.ball_hit_valid[:, [0, 2]]
           & (c1.ball_hit_tick[:, [0, 2]]
              == phys.arena.tick_count[:, None])).all(-1))


def flipped(env, phys, got, live):
    event("a back-wall hit flipped the target",
          live.want.arena.ball.hs_y_target_dir
          == -phys.arena.ball.hs_y_target_dir)


def on_floor(env, phys, got, live):
    event("the puck touched the floor (ground stick)", live.snow.floor)


def snow_walled(env, phys, got, live):
    event("the puck touched a side or corner wall", live.snow.wall)


HS_PLANE = ArenaParams(num_cars=CARS, use_mesh=False,
                       dynamic_wheel_rays=False, game_mode="heatseeker")
# case -> (mode, crafted state, arena on the plane, random controls, check)
MODE_CASES = {
    "hs_steer": ("heatseeker", "hs_flight", False, True, steered),
    "hs_touch": ("heatseeker", "hs_touch", False, False, both_touched),
    "hs_backwall": ("heatseeker", "hs_backwall", False, False, flipped),
    "hs_backwall_plane": ("heatseeker", "hs_backwall", True, False, flipped),
    "snow_floor": ("snowday", "snow_floor", False, False, on_floor),
    "snow_wall": ("snowday", "snow_wall", False, False, snow_walled)}


@pytest.mark.card
@pytest.mark.parametrize("case", list(MODE_CASES))
def test_game_mode_kernel_equals_plain(mode_envs, case, card):
    mode, craft, plane, moving, check = MODE_CASES[case]
    env, base = mode_envs[mode]
    params = HS_PLANE if plane else env.params
    gen = torch.Generator(device=card).manual_seed(SEED)
    phys = getattr(States(gen), craft)(base)
    ctl = random_controls(gen) if moving else still(card)
    got, live = kernel_and_plain(phys, ctl, respawn_draws(gen), params,
                                 env.teams_np)
    check(env, phys, got, live)
    compare(got, live.want, 0)
