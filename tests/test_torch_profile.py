"""CPU smokes of the port's profilers (reinforcement_learning_torch/tools/
profile_split.py and profile_phys.py, the twins of the JAX package's
tools/profile_split.py and profile_phys.py): every printed field at a
tiny width, the numbers they return, the backend table, and that they
run on the card unless the CPU is asked for.  The timings themselves
come from the card (chip_smoke.py's [profile] phase)."""

from __future__ import annotations

import re

import pytest
import torch

from reinforcement_learning_torch.physics.step import ArenaParams
from reinforcement_learning_torch.tools import profile_phys, profile_split

torch.set_num_threads(1)

TINY_PPO = dict(policy_layers=(8,), critic_layers=(8,),
                shared_head_layers=(8,), batch_size=8, epochs=1,
                half_precision=False)
PLANES = ArenaParams(num_cars=4, use_mesh=False, dynamic_wheel_rays=False)
NUM = r"([\d,]+(?:\.\d+)?)"


@pytest.fixture
def tiny_split(monkeypatch):
    """profile_split at a tiny width: 8-wide models, one env step an
    iteration, one timed call a region, the portable engine on the
    analytic planes."""
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    monkeypatch.setattr(profile_split, "PPO", TINY_PPO)
    monkeypatch.setattr(profile_split, "TS_PER_ITR", 8)
    monkeypatch.setattr(profile_split, "ITERS", 1)
    monkeypatch.setattr(profile_split, "FULL_ITERS", 1)
    monkeypatch.setattr(profile_split, "make_env", lambda N, device: (
        RocketLeagueEnv(EnvConfig(num_envs=N, team_size=2, device=device,
                                  arena=PLANES,
                                  physics_backend="portable"))))


def test_profile_split_prints_every_field(tiny_split, capsys):
    out = profile_split.profile(2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# N=2 T=1 players=8 buffer=8"
    names = ["env-only (random actions)", "rollout (policy+env)",
             "inference only (T fwd)", "ppo update (2 epochs)",
             "critic value pass (x1)", "full train_iteration"]
    keys = ["env", "rollout", "inference", "update", "values", "full"]
    assert list(out) == keys
    assert len(lines) == 8
    for line, name, key in zip(lines[1:7], names, keys):
        m = re.fullmatch(re.escape(name) + r" +" + NUM
                         + r" ms/iter   \(" + NUM + r" steps/s at T=1\)",
                         line)
        assert m, line
        ms = float(m.group(1).replace(",", ""))
        assert ms == pytest.approx(out[key] * 1e3, abs=0.006)
        rate = float(m.group(2).replace(",", ""))
        assert rate == pytest.approx(8 / out[key], rel=1e-3, abs=1)
        assert out[key] > 0
    m = re.fullmatch(r"# rollout\+update\+2\*values = " + NUM
                     + r" ms vs full " + NUM + r" ms", lines[7])
    assert m, lines[7]
    assert float(m.group(1)) == pytest.approx(
        (out["rollout"] + out["update"] + 2 * out["values"]) * 1e3,
        abs=0.06)
    assert float(m.group(2)) == pytest.approx(out["full"] * 1e3, abs=0.06)


def test_profile_split_takes_the_main_path_config():
    assert profile_split.PPO == dict(
        policy_layers=(384, 384, 384), critic_layers=(384, 384, 384),
        shared_head_layers=(384, 384), batch_size=50_000, epochs=2,
        half_precision=True)
    assert profile_split.TS_PER_ITR == 100_000
    assert (profile_split.ITERS, profile_split.FULL_ITERS) == (10, 5)
    env = profile_split.make_env(2, "cpu")
    assert (env.config.num_envs, env.config.team_size) == (2, 2)
    assert not env.portable and env.params.game_mode == "soccar"
    assert env.params.use_mesh and env.params.dynamic_wheel_rays


def test_profile_phys_prints_every_field(monkeypatch, capsys):
    monkeypatch.setattr(profile_phys, "ITERS", 1)
    out = profile_phys.main(1, ("planes",), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines == [lines[0], lines[1]]
    assert lines[0] == "# device=cpu (cpu) num_envs=1"
    m = re.fullmatch(r"planes      first call +" + NUM + r"s +" + NUM
                     + r" ms/step +" + NUM + r" env-steps/s \( +" + NUM
                     + r" player-steps/s\)", lines[1])
    assert m, lines[1]
    r = out["planes"]
    assert set(r) == {"first_s", "ms_per_step", "env_steps_per_s",
                      "player_steps_per_s"}
    assert float(m.group(2)) == pytest.approx(r["ms_per_step"], abs=0.006)
    assert r["env_steps_per_s"] == pytest.approx(1e3 / r["ms_per_step"])
    assert r["player_steps_per_s"] == pytest.approx(4 * r["env_steps_per_s"])
    assert r["first_s"] > 0


@pytest.mark.parametrize("label", list(profile_phys.BACKENDS))
def test_profile_phys_backends_map_to_the_routes(label):
    """The JAX labels' routes: mesh -> portable on the mesh with dynamic
    rays, planes -> portable on the planes, pallas -> kernel on the plane
    arena, pallas_mesh -> kernel_mesh at full fidelity."""
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    backend, mesh, rays = profile_phys.BACKENDS[label]
    env = RocketLeagueEnv(EnvConfig(
        num_envs=1, team_size=2, device="cpu", physics_backend=backend,
        arena=ArenaParams(num_cars=4, use_mesh=mesh,
                          dynamic_wheel_rays=rays)))
    assert env.portable == (label in ("portable", "planes"))
    assert env.params.use_mesh == env.params.dynamic_wheel_rays == (
        label in ("portable", "kernel_mesh"))


def test_profilers_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_phys.main(1, ("planes",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_split.profile(2)
