"""The trained policies into a match, on the card.

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).

- the train_2v2 twin's checkpoint after a warm-up and 3 iterations (768
  wide, leaky ReLU; ``torch_card.twin``) into ``InferUnit`` on the card:
  its logits on the obs rows of two more env steps against the trainer's
  own fp32 forward within 1e-5, its deterministic actions the masked
  argmax but where the top-two margin is within the logit tolerance;
- the bench-shape ReLU model after the main path's 5 updates (a warm-up,
  3 iterations and one split; ``torch_card.bench_run``) exported to the
  C++ runtime
  (``deploy/native``), held on the host against ``InferUnit`` on the card
  and the port's CPU forward (rtol 2e-4, atol 2e-5, as
  tests/test_native_infer.py holds the JAX package's), deterministic
  actions differing only within the top-two margin;
- a scripted 2v2 session of 600 ticks at tick_skip 8 and action_delay 7
  through the native bot server (four bots), through ``RLBotAdapter`` on
  the same runtime (equal controls at every tick) and on the card's
  ``InferUnit`` (equal but after a decision within the margin);
- the converter's round trips (checkpoint -> .pt -> .npz and -> .lt ->
  .npz, into ``InferUnit``), logits bit-equal.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from reinforcement_learning_torch.deploy import bot_bridge, native
from reinforcement_learning_torch.deploy.infer import InferUnit
from reinforcement_learning_torch.deploy.rlbot_agent import (PacketPlayer,
                                                             RLBotAdapter)
from reinforcement_learning_torch.envs.actions import DefaultAction
from reinforcement_learning_torch.envs.obs import AdvancedObs
from reinforcement_learning_torch.tools import checkpoint_converter as cv
from torch_card import bench_run, card, twin

# the C++ runtime against torch's forward, as tests/test_native_infer.py
# holds the JAX package's: |a - b| <= ATOL + RTOL |b|
LOGIT_RTOL, LOGIT_ATOL = 2e-4, 2e-5


def top2_margin(logits, masks):
    """The gap between the two largest legal logits of each row."""
    top = torch.where(masks, logits, -torch.inf).topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def assert_flips_allowed(a, b, logits, masks):
    """Deterministic actions ``a`` and ``b`` differ only on rows whose
    top-two margin is within twice the logit tolerance."""
    differ = a.cpu() != b.cpu()
    margin = top2_margin(logits, masks).cpu()
    tol = 2 * (LOGIT_ATOL + LOGIT_RTOL * logits.abs().amax(-1).cpu())
    bad = differ & (margin > tol)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} deterministic actions differ where the top-two "
        "margin allows none")


@pytest.mark.card
def test_checkpoint_into_infer_unit(twin, card):
    unit = InferUnit.from_checkpoint(twin["checkpoint"], 2, twin["ppo"],
                                     device=card)
    assert unit.learner.param_counts()["total"] == twin["params"]
    got = unit.logits(twin["obs"])
    assert float((got - twin["logits"]).abs().max()) <= 1e-5
    assert_flips_allowed(
        unit.infer_actions(twin["obs"], twin["masks"]),
        torch.where(twin["masks"], twin["logits"], -torch.inf).argmax(-1),
        twin["logits"], twin["masks"])


@pytest.mark.card
def test_native_runtime_agrees(bench_run, card):
    learner, obs, masks = (bench_run[k] for k in ("learner", "obs",
                                                    "masks"))
    pol = native.NativePolicy(native.export_policy_blob(learner))
    unit = InferUnit.from_params(learner.params_to_jax(), 2,
                                 learner.config, device=card)
    cpu = InferUnit.from_params(learner.params_to_jax(), 2,
                                learner.config, device="cpu")
    obs_np, masks_np = obs.cpu().numpy(), masks.cpu().numpy()
    lg_host = torch.from_numpy(pol.logits(obs_np))
    lg_card = unit.logits(obs).cpu()
    lg_cpu = cpu.logits(obs.cpu())
    for name, a, b in (("C++ vs card", lg_host, lg_card),
                       ("C++ vs torch CPU", lg_host, lg_cpu),
                       ("card vs torch CPU", lg_card, lg_cpu)):
        excess = ((a - b).abs() - LOGIT_RTOL * b.abs()).amax()
        assert float(excess) <= LOGIT_ATOL, name
    a_host = torch.from_numpy(pol.infer(obs_np, masks_np).astype(np.int64))
    assert_flips_allowed(a_host, unit.infer_actions(obs, masks), lg_card,
                         masks.cpu())


def scripted_2v2(n_ticks):
    """``n_ticks`` game ticks (120 Hz) of a scripted 2v2 as bot-server
    packets: four cars circling on their own halves at different radii
    and rates, each in the air for a second in four with its jump flag
    set, boost draining from different levels to 0 and refilling, the ball
    bouncing across the field and the pads switching in a pattern."""
    packets = []
    for t in range(n_ticks):
        s = t / 120.0
        players = []
        for i in range(4):
            team = i // 2
            r, w = 500.0 + 350.0 * i, 0.7 + 0.3 * i
            ph = w * s + i * math.pi / 2
            air = (t // 120 + i) % 4 == 0
            z = 17.01 + (180.0 * math.sin(math.pi * (t % 120) / 120)
                         if air else 0.0)
            players.append(dict(
                pos=(r * math.cos(ph), r * math.sin(ph)
                     + (2000.0 if team else -2000.0), z),
                yaw=math.remainder(ph + math.pi / 2, 2 * math.pi),
                pitch=0.3 * math.sin(3 * s + i) if air else 0.0,
                roll=0.5 * math.sin(2 * s + i) if air else 0.0,
                vel=(-r * w * math.sin(ph), r * w * math.cos(ph),
                     (180.0 * math.pi * math.cos(math.pi * (t % 120) / 120))
                     if air else 0.0),
                ang_vel=(0.0, 0.0, w), boost=max(0.0, (33.0 * i - 20.0 * s)
                                                 % 110.0 - 10.0),
                team=team, is_on_ground=not air, has_jumped=air))
        bx = 3000.0 * math.sin(0.4 * s)
        bz = 93.15 + abs(600.0 * math.sin(1.3 * s))
        packets.append(dict(
            seconds_elapsed=s, ball_pos=(bx, 4000.0 * math.sin(0.23 * s), bz),
            ball_vel=(1200.0 * math.cos(0.4 * s), 920.0 * math.cos(0.23 * s),
                      780.0 * math.cos(1.3 * s)),
            ball_ang_vel=(1.0, -2.0, 0.5 * math.sin(s)), players=players,
            pads_active=np.array([(t // 90 + k) % 3 != 0 for k in range(34)]),
            pads_timer=np.zeros(34, np.float32)))
    return packets


def packet_players(pkt):
    """A scripted packet's players as ``RLBotAdapter`` takes them."""
    return [PacketPlayer(
        pos=np.asarray(p["pos"], np.float32), yaw=p["yaw"], pitch=p["pitch"],
        roll=p["roll"], vel=np.asarray(p["vel"], np.float32),
        ang_vel=np.asarray(p["ang_vel"], np.float32), boost=p["boost"],
        team=p["team"], is_on_ground=p["is_on_ground"],
        has_jumped=p["has_jumped"]) for p in pkt["players"]]


@pytest.mark.card
def test_bot_server_session(bench_run, card, tmp_path):
    learner = bench_run["learner"]
    blob = native.export_policy_blob(learner)
    pol = native.NativePolicy(blob)
    unit = InferUnit.from_params(learner.params_to_jax(), 2,
                                 learner.config, device=card)
    packets = scripted_2v2(600)
    blob_path = tmp_path / "policy.blob"
    blob_path.write_bytes(blob)
    bots = ((0, 0), (0, 1), (1, 2), (1, 3))
    with bot_bridge.BotServer(str(blob_path), tick_skip=8, action_delay=7,
                              workdir=str(tmp_path)) as server:
        for team, index in bots:
            bot_bridge.add_bot(server.port, f"bot{index}", team, index)
        client = bot_bridge.PacketClient(server.port)
        try:
            served = [client.send_packet(**p) for p in packets]
        finally:
            client.close()
    server_ctl = np.stack([[out[i] for _, i in bots] for out in served])

    # the game machine builds the obs on the host; the policy runs in the
    # C++ runtime there or in InferUnit on the card
    host_obs = AdvancedObs(4, unit.obs_builder.teams_np, device="cpu")
    host_parser = DefaultAction(device="cpu")

    def session(infer):
        adapters = [RLBotAdapter(infer, host_obs, host_parser, tick_skip=8,
                                 action_delay=7) for _ in bots]
        ctl = []
        for p in packets:
            players = packet_players(p)
            ctl.append([a.get_output(p["seconds_elapsed"], p["ball_pos"],
                                     p["ball_vel"], p["ball_ang_vel"],
                                     players, p["pads_active"], i)
                        for a, (_, i) in zip(adapters, bots)])
        return np.stack(ctl).astype(np.float32)

    def native_infer(o, m):
        return int(pol.infer(o[None].numpy(), m[None].numpy())[0])
    host_ctl = session(native_infer)
    assert np.array_equal(host_ctl, server_ctl)
    flips = []

    def card_infer(o, m):
        a = int(unit.infer_actions(o[None], m[None])[0])
        b = native_infer(o, m)
        if a != b:
            assert_flips_allowed(torch.tensor([a]), torch.tensor([b]),
                                 unit.logits(o[None]).cpu(), m[None])
            flips.append(a)
        return a
    card_ctl = session(card_infer)
    assert flips or np.array_equal(card_ctl, server_ctl)


@pytest.mark.card
def test_converter_round_trips(twin, card, tmp_path):
    ck, ppo = twin["checkpoint"], twin["ppo"]
    got = InferUnit.from_checkpoint(ck, 2, ppo,
                                    device=card).logits(twin["obs"])
    cv.export_to_torch(ck, str(tmp_path / "pt"))
    cv.import_from_torch(str(tmp_path / "pt"), str(tmp_path / "p.npz"))
    via_pt = InferUnit.from_npz(str(tmp_path / "p.npz"), 2, ppo,
                                device=card).logits(twin["obs"])
    cv.export_to_lt(ck, str(tmp_path / "lt"), ppo.activation)
    cv.import_from_lt(str(tmp_path / "lt"), str(tmp_path / "lt.npz"))
    via_lt = InferUnit.from_npz(str(tmp_path / "lt.npz"), 2, ppo,
                                device=card).logits(twin["obs"])
    assert torch.equal(via_pt, got) and torch.equal(via_lt, got)
