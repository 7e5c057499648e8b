"""The port's deployment path held against the JAX package's: the native
C++ runtime and its policy blob (deploy/native.py), InferUnit
(deploy/infer.py), the bot server and its Python side (deploy/bot_bridge.py,
deploy/rlbot_agent.py, deploy/rlbot_packet_agent.py) and the checkpoint
converter (tools/checkpoint_converter.py).

The tests of tests/test_native_infer.py, test_bot_server.py,
test_rlbot_packet_agent.py and test_checkpoint.py's two converter tests are
mirrored on the port, and beside them the same seeded numpy parameters and
packets go through both packages: the blob byte for byte, the converter's
``.npz`` into both InferUnits (equal actions), both servers on the same
packets (equal controls, both ways across the wire), and the adapter's obs
row (to 1e-6).  The C++ runtime against the port's forward: rtol 2e-4,
atol 2e-5, as the JAX package holds it.  The servers run on 127.0.0.1.
"""

from __future__ import annotations

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from reinforcement_learning_torch import constants as TC
from reinforcement_learning_torch.deploy import bot_bridge as tbb
from reinforcement_learning_torch.deploy import native as tnative
from reinforcement_learning_torch.deploy import rlbot_packet_agent as rpa
from reinforcement_learning_torch.deploy.infer import InferUnit
from reinforcement_learning_torch.deploy.rlbot_agent import (PacketPlayer,
                                                             RLBotAdapter)
from reinforcement_learning_torch.envs.actions import DefaultAction
from reinforcement_learning_torch.envs.obs import AdvancedObs
from reinforcement_learning_torch.learn.ppo import PPOConfig, PPOLearner
from reinforcement_learning_torch.tools import checkpoint_converter as tconv
from reinforcement_learning_tpu.deploy import bot_bridge as jbb
from reinforcement_learning_tpu.deploy import native as jnative
from tests.test_bot_server import _random_policy
from tests.test_bot_server import _scripted_packets as jax_scripted_packets
from tests.test_rlbot_packet_agent import _fake_game_tick_packet, _vec

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

torch.set_num_threads(1)

OBS_1V1 = 9 + 8 + 34 + 2 * 29    # AdvancedObs, 1v1


def _learner(cfg: PPOConfig, obs_size=20, num_actions=10, seed=0):
    return PPOLearner(obs_size, num_actions, cfg, device="cpu", seed=seed)


# ---------------------------------------------------------------------------
# test_native_infer.py mirrored, and the blob against the JAX exporter's

@pytest.fixture(scope="module")
def setup():
    cfg = PPOConfig(policy_layers=(32, 32), critic_layers=(16,),
                    shared_head_layers=(24,), half_precision=False)
    learner = _learner(cfg)
    return learner, tnative.NativePolicy.from_learner(learner)


def test_logits_match_torch(setup):
    learner, pol = setup
    obs = np.random.RandomState(0).randn(16, 20).astype(np.float32)
    with torch.no_grad():
        want = learner.policy(learner.shared_head(torch.from_numpy(obs)))
    np.testing.assert_allclose(pol.logits(obs), want.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_deterministic_actions_match(setup):
    learner, pol = setup
    rng = np.random.RandomState(1)
    obs = rng.randn(32, 20).astype(np.float32)
    masks = rng.rand(32, 10) > 0.3
    masks[:, 0] = True
    got = pol.infer(obs, masks, deterministic=True)
    want, _ = learner.sample_actions(torch.from_numpy(obs),
                                     torch.from_numpy(masks),
                                     deterministic=True)
    np.testing.assert_array_equal(got, want.numpy())


def test_masked_sampling_legal(setup):
    _, pol = setup
    obs = np.random.RandomState(2).randn(64, 20).astype(np.float32)
    masks = np.zeros((64, 10), bool)
    masks[:, 3] = True
    masks[:, 7] = True
    actions = pol.infer(obs, masks, deterministic=False, seed=42)
    assert set(np.unique(actions)).issubset({3, 7})


@pytest.mark.parametrize("shared", [True, False])
def test_blob_byte_equal_to_jax(shared):
    """The port's blob of a learner equals the JAX exporter's for the same
    parameters, byte for byte."""
    cfg = PPOConfig(policy_layers=(32, 24), critic_layers=(16,),
                    shared_head_layers=(24,) if shared else (),
                    half_precision=False)
    learner = _learner(cfg, seed=3)
    tree = learner.params_to_jax()
    params = types.SimpleNamespace(shared_head=tree["shared_head"],
                                   policy=tree["policy"])
    assert tnative.export_policy_blob(learner) == \
        jnative.export_policy_blob(params, 20, 10)


def test_export_refuses_other_activations():
    """The runtime computes ReLU only and the blob has no activation field:
    the port's exporter raises for the others (the JAX one writes them as
    ReLU)."""
    for act in ("leaky_relu", "sigmoid", "tanh"):
        learner = _learner(PPOConfig(policy_layers=(8,), critic_layers=(8,),
                                     shared_head_layers=(),
                                     activation=act))
        with pytest.raises(ValueError, match="ReLU only"):
            tnative.export_policy_blob(learner)
        with pytest.raises(ValueError, match="ReLU only"):
            tnative.NativePolicy.from_learner(learner)


def test_native_builds_from_the_ports_sources_under_build():
    """The C++ is the port's own copy, compiled into build/torch_native/
    under a name keyed on the sources and flags; nothing is written into
    either package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib, server = tnative.build_library(), tbb.build_server()
    for path in (lib, server):
        assert os.path.dirname(str(path)) == os.path.join(
            root, "build", "torch_native"), path
    assert str(tnative.NATIVE_DIR) == os.path.join(
        root, "reinforcement_learning_torch", "deploy", "native")
    assert tnative.build_library() == lib    # cached: the same file
    assert "march=native" not in " ".join(tnative.CXX_FLAGS)


# ---------------------------------------------------------------------------
# test_bot_server.py mirrored, and across the two packages

def _scripted_packets(T):
    """T game ticks of the JAX test's scripted 1v1."""
    return jax_scripted_packets(T, None)


def _players(pkt):
    return [PacketPlayer(
        pos=np.asarray(p["pos"], np.float32), yaw=p["yaw"], pitch=p["pitch"],
        roll=p["roll"], vel=np.asarray(p["vel"], np.float32),
        ang_vel=np.asarray(p["ang_vel"], np.float32), boost=p["boost"],
        team=p["team"]) for p in pkt["players"]]


@pytest.fixture(scope="module")
def policy_blob(tmp_path_factory):
    """The JAX test's 32-wide LayerNorm policy with random weights, in a
    port learner, and its blob on disk."""
    tree = _random_policy(np.random.default_rng(7), OBS_1V1, 90).policy
    learner = _learner(PPOConfig(policy_layers=(32, 32), critic_layers=(16,),
                                 shared_head_layers=(),
                                 half_precision=False), OBS_1V1, 90)
    learner.policy.load_jax(tree)
    path = tmp_path_factory.mktemp("deploy") / "policy.blob"
    path.write_bytes(tnative.export_policy_blob(learner))
    return str(path), learner, tree


def _server_session(server, packets, bots=((0, 0),)):
    for team, index in bots:
        tbb.add_bot(server.port, f"bot{index}", team, index)
    client = tbb.PacketClient(server.port)
    try:
        return [client.send_packet(**pkt) for pkt in packets]
    finally:
        client.close()


def test_scripted_session_matches_python_adapter(policy_blob, tmp_path):
    """A scripted session through the port's native server (the "add"
    command, the binary packet stream, the tick-skip / action-delay
    cadence) gives the controls of the port's RLBotAdapter running the same
    policy on the same packets, exactly."""
    blob_path, learner, _ = policy_blob
    packets = _scripted_packets(64)
    with tbb.BotServer(blob_path, tick_skip=8, action_delay=7,
                       workdir=str(tmp_path)) as server:
        native_controls = np.stack(
            [out[0] for out in _server_session(server, packets)])

    policy = tnative.NativePolicy.from_learner(learner)

    def infer(obs_row, mask_row):
        return int(policy.infer(obs_row[None].numpy(), mask_row[None].numpy(),
                                deterministic=True)[0])

    adapter = RLBotAdapter(infer, AdvancedObs(2, np.array([0, 1]),
                                              device="cpu"),
                           DefaultAction(device="cpu"), tick_skip=8,
                           action_delay=7)
    py_controls = np.stack([np.asarray(adapter.get_output(
        pkt["seconds_elapsed"], pkt["ball_pos"], pkt["ball_vel"],
        pkt["ball_ang_vel"], _players(pkt), np.ones(34, bool), 0),
        np.float32) for pkt in packets])
    assert np.array_equal(native_controls, py_controls), (
        np.nonzero(np.any(native_controls != py_controls, axis=1)))
    # controls change only on action-application ticks: 8k+6 after the
    # first application at tick 0
    change_ticks = np.nonzero(np.any(np.diff(native_controls, axis=0)
                                     != 0, axis=1))[0] + 1
    assert all((t - 6) % 8 == 0 for t in change_ticks), change_ticks


def test_add_remove_commands(policy_blob, tmp_path):
    blob_path, *_ = policy_blob
    packets = _scripted_packets(4)
    with tbb.BotServer(blob_path, workdir=str(tmp_path)) as server:
        tbb.add_bot(server.port, "a", 0, 0)
        tbb.add_bot(server.port, "b", 1, 1)
        client = tbb.PacketClient(server.port)
        assert set(client.send_packet(**packets[0])) == {0, 1}
        client.close()
        tbb.remove_bot(server.port, 1)
        client = tbb.PacketClient(server.port)
        assert set(client.send_packet(**packets[1])) == {0}
        client.close()


def test_servers_agree_across_packages(policy_blob, tmp_path, monkeypatch):
    """The port's server and a server built from the JAX package's C++ give
    the same controls on the same packets for both bots, each driven by the
    other package's Python client (pack_packet, PacketClient, add_bot)."""
    blob_path, *_ = policy_blob
    packets = _scripted_packets(48)
    jax_dir = os.path.join(os.path.dirname(jbb.__file__), "native")
    jax_server = str(tnative.build_native(
        "rlt_bot_server_jax", [os.path.join(jax_dir, "bot_server.cpp"),
                               os.path.join(jax_dir, "mlp_infer.cpp")],
        tnative.CXX_FLAGS))

    def session(client_mod, workdir):
        with tbb.BotServer(blob_path, workdir=workdir) as server:
            for team, index in ((0, 0), (1, 1)):
                client_mod.add_bot(server.port, f"b{index}", team, index)
            client = client_mod.PacketClient(server.port)
            try:
                return [client.send_packet(**p) for p in packets]
            finally:
                client.close()

    port_server = session(jbb, str(tmp_path))
    monkeypatch.setattr(tbb, "build_server", lambda: jax_server)
    jax_server_run = session(tbb, str(tmp_path))
    for a, b in zip(port_server, jax_server_run):
        assert a.keys() == b.keys() == {0, 1}
        for idx in a:
            np.testing.assert_array_equal(a[idx], b[idx])
    for p in packets[:3]:
        assert tbb.pack_packet(**p) == jbb.pack_packet(**p)


def test_build_obs_matches_jax(policy_blob):
    """RLBotAdapter.build_obs equals the JAX adapter's on 2v2 packets with
    a canonical-order pad pattern and a previous action: the obs row to
    1e-6 and the action mask exactly."""
    from reinforcement_learning_tpu.deploy.rlbot_agent import \
        PacketPlayer as JPlayer
    from reinforcement_learning_tpu.deploy.rlbot_agent import \
        RLBotAdapter as JAdapter
    from reinforcement_learning_tpu.envs.actions import \
        DefaultAction as JAction
    from reinforcement_learning_tpu.envs.obs import AdvancedObs as JObs

    rng = np.random.default_rng(5)
    teams = np.array([0, 0, 1, 1])
    port = RLBotAdapter(None, AdvancedObs(4, teams, device="cpu"))
    ref = JAdapter(None, JObs(4, teams), JAction())
    prev = DefaultAction(device="cpu").table_np[17]
    port.controls, ref.controls = prev.copy(), prev.copy()
    pads = rng.uniform(size=34) < 0.5
    for trial in range(3):
        kw = [dict(pos=rng.uniform(-3000, 3000, 3).astype(np.float32),
                   yaw=float(rng.uniform(-3, 3)),
                   pitch=float(rng.uniform(-1, 1)),
                   roll=float(rng.uniform(-3, 3)),
                   vel=rng.uniform(-1500, 1500, 3).astype(np.float32),
                   ang_vel=rng.uniform(-5, 5, 3).astype(np.float32),
                   boost=float(rng.uniform(0, 100)) * (trial != 1),
                   team=int(t), is_on_ground=bool(rng.uniform() < 0.5),
                   has_jumped=bool(rng.uniform() < 0.5),
                   is_demoed=bool(rng.uniform() < 0.2)) for t in teams]
        ball = [rng.uniform(-2000, 2000, 3) for _ in range(3)]
        for me in range(4):
            got = port.build_obs(*ball, [PacketPlayer(**k) for k in kw],
                                 pads, me)
            want = ref.build_obs(*ball, [JPlayer(**k) for k in kw], pads, me)
            np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_array_equal(got[1].numpy(), want[1])


# ---------------------------------------------------------------------------
# test_rlbot_packet_agent.py mirrored

def test_translate_field_coverage():
    """Every translated field, including the flags the scripted match never
    varies: an airborne car that never jumped is not on the ground
    (isOnGround = hasWheelContact(), RLBotClient.cpp:54)."""
    def car(wheel, jumped, dj, demo):
        return types.SimpleNamespace(
            physics=types.SimpleNamespace(
                location=_vec(100, 200, 300),
                rotation=types.SimpleNamespace(pitch=0.1, yaw=0.2, roll=0.3),
                velocity=_vec(10, 20, 30), angular_velocity=_vec(1, 2, 3)),
            boost=77.0, team=1, jumped=jumped, double_jumped=dj,
            is_demolished=demo, has_wheel_contact=wheel)

    cars = [car(True, False, False, False), car(False, False, False, False),
            car(False, True, False, False), car(False, True, True, False),
            car(True, False, False, True)]
    ball = types.SimpleNamespace(physics=types.SimpleNamespace(
        location=_vec(5, 6, 93), velocity=_vec(-1, -2, -3),
        angular_velocity=_vec(0.5, 0.25, -0.5)))
    ref = np.asarray(TC.BOOST_PAD_LOCS_SOCCAR)
    boosts = [types.SimpleNamespace(is_active=(i % 2 == 0), timer=float(i))
              for i in range(len(ref))]
    pkt = types.SimpleNamespace(
        game_cars=cars, num_cars=len(cars), game_ball=ball,
        game_boosts=boosts, num_boost=len(boosts),
        game_info=types.SimpleNamespace(seconds_elapsed=12.5))
    out = rpa.translate_game_tick_packet(
        pkt, rpa.build_pad_map([tuple(r) for r in ref]))
    assert out["seconds_elapsed"] == 12.5
    assert out["ball_pos"] == (5.0, 6.0, 93.0)
    assert out["ball_vel"] == (-1.0, -2.0, -3.0)
    assert out["ball_ang_vel"] == (0.5, 0.25, -0.5)
    players = out["players"]
    assert [p["is_on_ground"] for p in players] == [
        True, False, False, False, True]
    assert [p["has_jumped"] for p in players] == [
        False, False, True, True, False]
    assert [p["has_double_jumped"] for p in players] == [
        False, False, False, True, False]
    assert [p["is_demoed"] for p in players] == [
        False, False, False, False, True]
    p0 = players[0]
    assert p0["pos"] == (100.0, 200.0, 300.0)
    assert (p0["pitch"], p0["yaw"], p0["roll"]) == (0.1, 0.2, 0.3)
    assert p0["vel"] == (10.0, 20.0, 30.0)
    assert p0["ang_vel"] == (1.0, 2.0, 3.0)
    assert p0["boost"] == 77.0 and p0["team"] == 1
    np.testing.assert_array_equal(out["pads_active"],
                                  [i % 2 == 0 for i in range(len(ref))])
    np.testing.assert_allclose(out["pads_timer"],
                               np.arange(len(ref), dtype=np.float32))


def test_pad_map_roundtrip():
    ref = np.asarray(TC.BOOST_PAD_LOCS_SOCCAR)
    order = np.random.RandomState(0).permutation(len(ref))
    assert (rpa.build_pad_map([tuple(ref[i]) for i in order])
            == order).all()


def test_translate_matches_direct_protocol(policy_blob, tmp_path):
    """A fake-GameTickPacket session through the translator gives the
    control stream of the direct pack_packet session."""
    blob_path, *_ = policy_blob
    packets = _scripted_packets(60)
    with tbb.BotServer(blob_path, workdir=str(tmp_path)) as server:
        direct = _server_session(server, packets)
    with tbb.BotServer(blob_path, workdir=str(tmp_path)) as server:
        tbb.add_bot(server.port, "gtp-bot", 0, 0)
        bridge = None
        via_gtp = []
        for p in packets:
            pkt, pad_locs = _fake_game_tick_packet(p)
            if bridge is None:
                bridge = rpa.NativeBridge(server.port, pad_locs)
            via_gtp.append(dict(bridge.step(pkt)))
        bridge.client.close()
    assert len(direct) == len(via_gtp)
    for a, b in zip(direct, via_gtp):
        assert a.keys() == b.keys()
        for idx in a:
            np.testing.assert_allclose(a[idx], b[idx], atol=1e-6)
    s = rpa.controls_to_simple_state(list(direct[-1].values())[0])
    assert hasattr(s, "throttle") and isinstance(s.jump, bool)


def test_real_ctypes_packet_bytes_end_to_end(policy_blob, tmp_path):
    """GameTickPacket and FieldInfoPacket as the rlbot framework's ctypes
    structures (tests/rlbot_structs.py), round-tripped through raw bytes,
    through the translator and the port's server: the control stream of
    the direct binary protocol."""
    from tests import rlbot_structs as rs

    blob_path, *_ = policy_blob
    packets = _scripted_packets(40)
    for p in packets:  # rlbot carries boost as c_int
        for pl in p["players"]:
            pl["boost"] = float(int(pl["boost"]))
    with tbb.BotServer(blob_path, workdir=str(tmp_path)) as server:
        direct = _server_session(server, packets)

    ref = np.asarray(TC.BOOST_PAD_LOCS_SOCCAR)
    order = np.random.RandomState(11).permutation(len(ref))
    fi = rs.FieldInfoPacket.from_buffer_copy(
        bytes(rs.build_field_info([tuple(ref[i]) for i in order])))
    pad_locs = [(fi.boost_pads[i].location.x, fi.boost_pads[i].location.y,
                 fi.boost_pads[i].location.z) for i in range(fi.num_boosts)]
    with tbb.BotServer(blob_path, workdir=str(tmp_path)) as server:
        tbb.add_bot(server.port, "ct-bot", 0, 0)
        bridge = rpa.NativeBridge(server.port, pad_locs)
        via_ctypes = [dict(bridge.step(rs.GameTickPacket.from_buffer_copy(
            bytes(rs.build_game_tick_packet(p))))) for p in packets]
        bridge.client.close()
    for a, b in zip(direct, via_ctypes):
        assert a.keys() == b.keys()
        for idx in a:
            np.testing.assert_allclose(a[idx], b[idx], atol=1e-6)


# ---------------------------------------------------------------------------
# InferUnit, and test_checkpoint.py's converter tests mirrored

SMALL = dict(policy_layers=(16, 16), critic_layers=(16,),
             shared_head_layers=(16,), half_precision=False, batch_size=8)


def _small_trainer(folder, **cfg):
    """1v1 at 2 arenas on the plane arena, 16-wide MLPs, on the CPU."""
    from reinforcement_learning_torch.envs import env as tenv
    from reinforcement_learning_torch.learn import trainer as ttrainer
    from reinforcement_learning_torch.physics import step as tstep
    env = tenv.RocketLeagueEnv(tenv.EnvConfig(
        num_envs=2, team_size=1, device="cpu", tick_skip=2, action_delay=1,
        arena=tstep.ArenaParams(num_cars=2, use_mesh=False,
                                dynamic_wheel_rays=False)))
    return ttrainer.Trainer(env, PPOConfig(**{**SMALL, **cfg}),
                            ttrainer.TrainerConfig(
                                ts_per_itr=8, random_seed=5,
                                checkpoint_folder=folder))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of a small 1v1 trainer (its learner drawn from
    seed 1) and the trainer."""
    folder = str(tmp_path_factory.mktemp("ck"))
    tr = _small_trainer(folder)
    tr.learner.init(1)
    return tr.save(tr.init(0)), tr


def test_converter_roundtrip(checkpoint, tmp_path):
    """checkpoint -> rlgym-ppo .pt -> .npz gives the learner's parameters
    back bit for bit; the JAX package's converter reads the port's .pt
    files into the same .npz."""
    import checkpoint_converter as jconv

    path, tr = checkpoint
    torch_dir = str(tmp_path / "torch")
    tconv.export_to_torch(path, torch_dir)
    for f in ("PPO_POLICY.pt", "PPO_VALUE_NET.pt", "PPO_SHARED_HEAD.pt"):
        assert os.path.exists(os.path.join(torch_dir, f)), f
    npz = str(tmp_path / "back.npz")
    tconv.import_from_torch(torch_dir, npz)
    jnpz = str(tmp_path / "jax.npz")
    jconv.import_from_torch(torch_dir, jnpz)
    orig = tr.learner.params_to_jax()
    for got in (tconv.load_npz_params(npz), jconv.load_npz_params(jnpz)):
        for name in ("policy", "critic", "shared_head"):
            for a, b in zip(got[name]["layers"], orig[name]["layers"]):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(got["policy"]["out"]["w"],
                                      orig["policy"]["out"]["w"])


def test_lt_converter_roundtrip(checkpoint, tmp_path):
    """GigaLearnCPP .lt torchscript export and import: params -> .lt ->
    params exactly, the torchscript forward equals the port's MLP (3e-5),
    and a checkpoint through to_lt / from_lt and InferUnit gives the
    learner's logits bit for bit."""
    from reinforcement_learning_torch.models.mlp import MLP, MLPConfig

    rng = np.random.default_rng(11)

    def layer(fi, fo):
        return {k: rng.normal(size=s).astype(np.float32) for k, s in
                (("w", (fi, fo)), ("b", fo), ("ln_scale", fo),
                 ("ln_bias", fo))}

    params = {"layers": [layer(9, 24), layer(24, 24)],
              "out": {"w": rng.normal(size=(24, 6)).astype(np.float32),
                      "b": rng.normal(size=6).astype(np.float32)}}
    lt = str(tmp_path / "POLICY.lt")
    torch.jit.save(torch.jit.script(tconv._build_torch_sequential(params)),
                   lt)
    loaded = torch.jit.load(lt)
    back = tconv._sequential_to_params(loaded)
    for a, b in zip(params["layers"], back["layers"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(params["out"]["w"], back["out"]["w"])
    x = rng.normal(size=(4, 9)).astype(np.float32)
    ours = MLP(MLPConfig(9, (24, 24), 6)).load_jax(params)(
        torch.from_numpy(x))
    np.testing.assert_allclose(ours.detach().numpy(),
                               loaded(torch.from_numpy(x)).detach().numpy(),
                               atol=3e-5)

    path, tr = checkpoint
    lt_dir = str(tmp_path / "lt")
    tconv.export_to_lt(path, lt_dir)
    npz = str(tmp_path / "from_lt.npz")
    tconv.import_from_lt(lt_dir, npz)
    obs = torch.from_numpy(rng.normal(size=(32, OBS_1V1)).astype(np.float32))
    want = InferUnit.from_checkpoint(path, 1, device="cpu").logits(obs)
    got = InferUnit.from_npz(npz, 1, device="cpu").logits(obs)
    assert torch.equal(got, want)


def test_infer_unit_from_checkpoint(checkpoint):
    """InferUnit.from_checkpoint: the trainer's fp32 logits exactly, the
    masked argmax, legal stochastic draws from an explicit generator, the
    controls; a given PPOConfig's activation is the one used."""
    path, tr = checkpoint
    unit = InferUnit.from_checkpoint(path, 1, device="cpu")
    assert unit.config.policy_layers == (16, 16)
    assert unit.config.shared_head_layers == (16,)
    rng = np.random.default_rng(2)
    obs = torch.from_numpy(rng.normal(size=(64, OBS_1V1)).astype(np.float32))
    masks = torch.from_numpy(rng.uniform(size=(64, 90)) < 0.4)
    masks[:, 5] = True
    with torch.no_grad():
        want = tr.learner.policy(tr.learner.shared_head(obs))
    assert torch.equal(unit.logits(obs), want)
    actions = unit.infer_actions(obs, masks)
    np.testing.assert_array_equal(
        actions.numpy(), torch.where(masks, want, -torch.inf).argmax(-1))
    np.testing.assert_array_equal(unit.infer_controls(obs, masks).numpy(),
                                  unit.action_parser.table_np[actions])
    sto = InferUnit.from_checkpoint(path, 1, deterministic=False,
                                    device="cpu")
    g = torch.Generator().manual_seed(3)
    a1 = sto.infer_actions(obs, masks, generator=g)
    assert bool(torch.gather(masks, 1, a1[:, None]).all())
    g.manual_seed(3)
    assert torch.equal(sto.infer_actions(obs, masks, generator=g), a1)

    leaky = InferUnit.from_checkpoint(
        path, 1, PPOConfig(**{**SMALL, "activation": "leaky_relu"}),
        device="cpu")
    lr = _small_trainer("", activation="leaky_relu").learner
    lr.load_state_dict(tr.learner.state_dict())
    with torch.no_grad():
        assert torch.equal(leaky.logits(obs),
                           lr.policy(lr.shared_head(obs)))


def test_jax_npz_to_port_infer_unit(tmp_path):
    """A .npz written by the JAX package's converter from a JAX learner's
    parameters: the port's InferUnit gives the JAX InferUnit's actions on
    all 256 rows, and the sizes it reads from the parameters."""
    import checkpoint_converter as jconv
    from reinforcement_learning_tpu.deploy.infer import \
        InferUnit as JInferUnit
    from reinforcement_learning_tpu.learn.ppo import PPOConfig as JConfig
    from reinforcement_learning_tpu.learn.ppo import PPOLearner as JLearner

    jl = JLearner(OBS_1V1, 90, JConfig(policy_layers=(32, 32),
                                  critic_layers=(16,),
                                  shared_head_layers=(24,),
                                  half_precision=False))
    params = jax.device_get(jl.init(jax.random.PRNGKey(4)).params)
    torch_dir = tmp_path / "pt"
    torch_dir.mkdir()
    for name, fname in (("policy", "PPO_POLICY.pt"),
                        ("critic", "PPO_VALUE_NET.pt"),
                        ("shared_head", "PPO_SHARED_HEAD.pt")):
        sd = jconv._flatten_mlp_to_torch(getattr(params, name))
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   str(torch_dir / fname))
    npz = str(tmp_path / "jax.npz")
    jconv.import_from_torch(str(torch_dir), npz)

    rng = np.random.default_rng(6)
    obs = rng.normal(size=(256, OBS_1V1)).astype(np.float32)
    masks = rng.uniform(size=(256, 90)) < 0.5
    masks[:, 0] = True
    port = InferUnit.from_npz(npz, 1, device="cpu")
    ref = JInferUnit.from_npz(npz, 1)
    np.testing.assert_array_equal(port.infer_actions(obs, masks).numpy(),
                                  ref.infer_actions(obs, masks))
    cfg = port.config
    assert (cfg.policy_layers, cfg.critic_layers, cfg.shared_head_layers,
            cfg.layer_norm, cfg.activation) == ((32, 32), (16,), (24,), True,
                                                "relu")


def test_adapter_on_infer_unit_matches_native(checkpoint, tmp_path):
    """RLBotAdapter.from_infer_unit (torch on the CPU here) and
    RLBotAdapter.from_npz (the C++ runtime) give the same controls on a
    scripted 1v1 session."""
    path, _ = checkpoint
    npz = str(tmp_path / "p.npz")
    tconv.export_to_torch(path, str(tmp_path / "pt"))
    tconv.import_from_torch(str(tmp_path / "pt"), npz)
    unit = InferUnit.from_checkpoint(path, 1, device="cpu")
    a = RLBotAdapter.from_infer_unit(unit, 0)
    b = RLBotAdapter.from_npz(npz, 1, 0)
    for pkt in _scripted_packets(40):
        args = (pkt["seconds_elapsed"], pkt["ball_pos"], pkt["ball_vel"],
                pkt["ball_ang_vel"], _players(pkt), np.ones(34, bool), 0)
        np.testing.assert_array_equal(a.get_output(*args),
                                      b.get_output(*args))


def test_converter_command_line(checkpoint, tmp_path):
    """``python -m reinforcement_learning_torch.tools.checkpoint_converter``
    in all four directions."""
    path, _ = checkpoint
    tconv.main(["to_torch", path, "--out", str(tmp_path / "pt")])
    tconv.main(["from_torch", str(tmp_path / "pt"), "--out",
                str(tmp_path / "a.npz")])
    tconv.main(["to_lt", path, "--out", str(tmp_path / "lt")])
    tconv.main(["from_lt", str(tmp_path / "lt"), "--out",
                str(tmp_path / "b.npz")])
    with np.load(str(tmp_path / "a.npz")) as a, \
            np.load(str(tmp_path / "b.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
