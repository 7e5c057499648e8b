"""Hoops on the port: the portable physics engine's hoops tick and env step
against the JAX engine's golden traces (tests/data/
torch_portable_golden.npz, made and compared as tests/test_torch_portable
.py says), the hoops tests of tests/test_game_modes.py mirrored on the port
(goal detection, pads and kickoff, arena geometry), the hoops env end to
end on the portable route, and AdvancedObs' pad gather, which clamps the
canonical soccar order's indices to hoops' 20 pads as the JAX package's
gather does.  Tolerances: the traces as tests/test_torch_portable.py;
the kickoff states and observations to 1e-5; goal flags exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.envs import state_setters as tsetters
from reinforcement_learning_torch.envs.obs import PAD_PERMUTATION
from reinforcement_learning_torch.physics import arena_geom as tgeom
from reinforcement_learning_torch.physics import step as tstep
from tests.test_torch_physics import CARS, TEAMS, flatten
from tests.test_torch_portable import (check_step, check_tick,
                                       hoops_scenarios, load_golden, stored)

torch.set_num_threads(1)

HOOPS = sorted(hoops_scenarios())


@pytest.mark.parametrize("name", HOOPS)
def test_hoops_tick_matches_jax(name):
    check_tick(name)


@pytest.mark.parametrize("name", HOOPS)
def test_hoops_step_matches_jax(name):
    check_step(name)


def test_hoops_scenarios_drive_their_events():
    """The traces score in the basket, bounce the ball off the rim and the
    basket wall, pick up a big pad and ride the side wall."""
    data = load_golden()
    out = stored(data, "hoops_rim/out/1/")
    first = stored(data, "hoops_rim/out/0/")
    goal = first["arena.goal_scored"] | out["arena.goal_scored"]
    assert goal[:2].all() and not goal[2:].any()
    vin = data["hoops_rim/in/arena.ball.vel"]
    assert (out["arena.ball.vel"][2:4, 2] > 0).all()           # the rim
    assert (out["arena.ball.vel"][4:6, 1] * vin[4:6, 1] < 0).all()
    assert (out["arena.cars.boost"][:, 1] > 10.0).all()        # big pads
    assert out["arena.cars.wheels_with_contact"][:, 0].all()   # side wall
    kick = stored(data, "hoops_kickoff/out/1/")
    assert (kick["arena.ball.pos"][:, 2] > 200.0).all()        # thrown up
    assert (kick["arena.ball.vel"][:, 2] > 0.0).all()


def test_hoops_goal_detection():
    """tests/test_game_modes.py's three points, and a grid of points
    against the JAX function."""
    import jax.numpy as jnp
    from reinforcement_learning_tpu.physics import step as jstep
    cy = TC.HOOPS_GOAL_OFFSET_Y / TC.HOOPS_GOAL_SCALE_Y
    pts = torch.tensor([[0.0, cy, 100.0], [0.0, 0.0, 100.0],
                        [0.0, cy, 500.0]])
    assert tstep._is_ball_scored_hoops(pts).tolist() == [True, False, False]
    g = np.stack(np.meshgrid(np.linspace(-900, 900, 13),
                             np.linspace(-3900, 3900, 27),
                             np.linspace(50, 400, 5)), -1).reshape(-1, 3)
    g = g.astype(np.float32)
    want = np.asarray(jstep._is_ball_scored_hoops(jnp.asarray(g.T)))
    got = tstep._is_ball_scored_hoops(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_hoops_pads_and_kickoff():
    """The hoops kickoff with the JAX package's shuffles handed in equals
    its state field by field: cars on the hoops spawn table, the ball
    thrown up, 20 pads."""
    import jax
    import jax.numpy as jnp
    from reinforcement_learning_tpu.envs import state_setters as jsetters
    from reinforcement_learning_tpu.physics import step as jstep
    n = 6
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    jp = jstep.ArenaParams(num_cars=CARS, game_mode="hoops")
    want = jax.vmap(lambda k: jsetters.kickoff_state()(
        k, jp, jnp.asarray(TEAMS)))(keys)
    orders = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(jax.random.split(k)[0])[0],
        TC.CAR_SPAWN_LOCATION_AMOUNT)) for k in keys])
    setter = tsetters.kickoff_state(
        order_fn=lambda num, g, d: torch.from_numpy(orders))
    tp = tstep.ArenaParams(num_cars=CARS, game_mode="hoops")
    got = setter(None, tp, torch.tensor(TEAMS), n, "cpu")
    assert got.arena.pads.is_active.shape == (n, TC.NUM_BOOST_PADS_HOOPS)
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k, v in w.items():
        np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                   np.asarray(v, np.float64), atol=1e-5,
                                   err_msg=k)
    assert (got.arena.ball.vel[:, 2] == TC.BALL_HOOPS_Z_VEL).all()
    pos = got.arena.cars.pos.numpy()
    tab = TC.CAR_SPAWN_LOCATIONS_HOOPS
    d = np.abs(np.abs(pos[..., None, :2]) - np.abs(tab[:, :2])).min(-2)
    assert d.max() < 1e-3


def test_soccar_unaffected_by_mode_plumbing():
    """The default soccar kickoff still has the ball at rest on the spot."""
    setter = tsetters.kickoff_state()
    phys = setter(torch.Generator().manual_seed(2),
                  tstep.ArenaParams(num_cars=2), torch.tensor([0, 1]), 3,
                  "cpu")
    assert torch.allclose(phys.arena.ball.pos[:, 2],
                          torch.tensor(TC.BALL_REST_Z))
    assert float(phys.arena.ball.vel.norm()) == 0.0


def test_hoops_arena_geometry():
    """Hoops uses its own, smaller plane set: a query outside the hoops
    side wall but inside the soccar arena touches in hoops only, and the
    hoops ceiling is lower."""
    pos = torch.tensor([TC.ARENA_EXTENT_X_HOOPS - 50.0, 0.0, 500.0])
    assert tgeom.sphere_contacts(pos, 96.4, "hoops")[2].any()
    assert not tgeom.sphere_contacts(pos, 96.4, "soccar")[2].any()
    top = torch.tensor([0.0, 0.0, TC.ARENA_HEIGHT_HOOPS - 50.0])
    assert tgeom.sphere_contacts(top, 96.4, "hoops")[2].any()


def test_hoops_env_steps_on_the_portable_route(monkeypatch):
    """RocketLeagueEnv in hoops (physics_backend "auto") at N=2: the
    portable engine, never the kernel; two env steps with finite
    observations; the step's physics is ``physics.step.arena_step`` with
    one respawn draw per car per tick from the env's generator."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel route ran in hoops")
    monkeypatch.setattr(tenv, "arena_step", no_kernel)
    env = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=2, team_size=2, game_mode="hoops", device="cpu"))
    assert env.portable and env.params.use_mesh
    state, obs, masks = env.reset(4)
    assert obs.shape == (2, 4, 167) and masks.shape == (2, 4, 90)
    assert (state.phys.ball.vel[:, 2] == TC.BALL_HOOPS_Z_VEL).all()
    actions = torch.from_numpy(np.random.RandomState(4).randint(
        0, env.num_actions, (2, 2, 4)))
    for t in range(2):
        gen_state = env.generator.get_state()
        controls = env.action_parser.parse(actions[t])
        before = state.phys
        state, out = env.step(state, actions[t])
        assert torch.isfinite(out.obs).all() and torch.isfinite(
            out.reward).all()
        # the same draws, taken the env's way
        gen = torch.Generator().set_state(gen_state)
        r = torch.randint(0, TC.CAR_RESPAWN_LOCATION_AMOUNT, (2, 8, 4),
                          generator=gen, dtype=torch.int32)
        want = tstep.arena_step(before, controls, env.teams_np, r,
                                env.params, 8, 7)
        if not out.terminal_type.any():
            for (k, a), b in zip(flatten(want).items(),
                                 flatten(state.phys).values()):
                assert torch.equal(torch.as_tensor(a),
                                   torch.as_tensor(b)), k
    assert float(state.phys.ball.pos[:, 2].min()) > 200.0


def test_obs_pad_clamp_matches_jax_reset():
    """The JAX env's hoops reset (the XLA route) builds AdvancedObs from a
    20-pad arena; its gather clamps every canonical pad index past 19 to
    pad 19.  The port's obs of the same state agree, clamp included."""
    import jax
    from reinforcement_learning_tpu.envs import env as jenv
    env = jenv.RocketLeagueEnv(jenv.EnvConfig(
        num_envs=1, team_size=2, game_mode="hoops", physics_backend="xla"))
    states, obs, _ = env.reset(jax.random.PRNGKey(0))
    obs = np.asarray(obs)
    assert obs.shape == (1, 4, 167)
    assert int(PAD_PERMUTATION.max()) == 33
    tenv_ = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=1, team_size=2, game_mode="hoops", device="cpu"))
    a = states.phys.arena

    def port(obj):
        return type(obj)(**{
            f.name: (port(getattr(obj, f.name))
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else torch.from_numpy(np.array(getattr(obj, f.name))))
            for f in dataclasses.fields(obj)})
    got = tenv_.obs_builder.build(port(a.cars), port(a.ball), port(a.pads),
                                  torch.from_numpy(np.array(
                                      states.prev_actions)))
    np.testing.assert_allclose(got.numpy(), obs, atol=1e-5)
    # a pad taken: every canonical slot mapped past pad 19 reads pad 19
    pads = port(a.pads)
    pads.is_active[:, 19] = False
    pads.cooldown[:, 19] = 4.0
    got = tenv_.obs_builder.build(port(a.cars), port(a.ball), pads,
                                  torch.zeros(1, 4, 8)).numpy()
    clamped = np.flatnonzero(PAD_PERMUTATION >= 19)
    np.testing.assert_allclose(got[0, 0, 17 + clamped], 1.0 / 5.0,
                               atol=1e-6)
