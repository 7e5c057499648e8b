"""BENCHMARK.json against the benchmark's contract, and every
configuration, cell and metric reader found by its name."""

import json
import re
from pathlib import Path

import pytest

from perfbench import flops, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_texts(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")


def test_workloads_and_metrics():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    # at most a quarter of the cells, rounded down, on 4 chips, or one
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(cells) // 4, 1)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"player_steps_per_s", "setup_s"}
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] == "player_steps_per_s"
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_and_config_load_by_name(workload):
    _, entry, cell, config = harness.spec(workload)
    assert config["name"] == entry["config"]
    assert set(cell["limits"]) >= {"physics_off", "env_off", "loss_gap",
                                   "grad1_gap", "change_gap", "gae_gap",
                                   "welford_gap", "logp_gap"}
    assert cell["window_unit"] in ("iteration", "cycle")
    c = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    assert config["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_ranks_are_the_chips(workload):
    from perfbench import program
    _, entry, cell, _ = harness.spec(workload)
    assert program.ranks(cell["traffic"]) == entry["chips"]
    if entry["chips"] > 1:
        assert {"replica_gap", "rank_steps_off"} <= set(cell["limits"])
        assert cell["limits"]["replica_gap"] == 0
        assert cell["limits"]["rank_steps_off"] == 0


def test_data_parallel_cell_scales_one_rank_by_the_ranks():
    from perfbench import program
    _, _, cell, config = harness.spec("bench-2v2.dp4")
    _, _, _, one = harness.spec("bench-2v2.train")
    assert config == one   # the configuration file states one rank's share
    whole = program.global_config(config, program.ranks(cell["traffic"]))
    assert whole["env"]["num_envs"] == 4096
    assert whole["trainer"]["ts_per_itr"] == 400_000
    assert (whole["ppo"]["ts_per_itr"], whole["ppo"]["batch_size"]) == (
        200_000, 200_000)
    # every rank keeps bench-2v2.train's 24 env steps an iteration and its
    # one minibatch an epoch
    players = whole["env"]["num_envs"] * 2 * whole["env"]["team_size"]
    assert whole["trainer"]["ts_per_itr"] // players == 24
    assert 24 * players // whole["ppo"]["batch_size"] == 1
    assert config["env"]["num_envs"] == 1024   # the file is left as it was
    for key in ("4096", "400000", "200000"):
        assert key in cell["why"]


def test_flops_hand_counts():
    # bench-2v2: 167 -> 384 -> 384 shared; 384 -> 384 x3 -> 90 policy;
    # 384 -> 384 x3 -> 1 critic; LayerNorm after each hidden layer
    _, _, _, bench = harness.spec("bench-2v2.train")
    t = flops.trio(bench)
    assert t["macs"] == {"shared_head": 167 * 384 + 384 * 384,
                         "policy": 3 * 384 * 384 + 384 * 90,
                         "critic": 3 * 384 * 384 + 384}
    assert sum(t["params"].values()) == 1_140_571 == bench["params"]
    # example-2v2: the example's 512s at scale 1.5 = 768
    _, _, _, example = harness.spec("example-2v2.train")
    t = flops.trio(example)
    assert t["macs"] == {"shared_head": 167 * 768 + 768 * 768,
                         "policy": 3 * 768 * 768 + 768 * 90,
                         "critic": 3 * 768 * 768 + 768}
    assert t["params"]["shared_head"] == (167 * 768 + 768) + (
        768 * 768 + 768) + 4 * 768
    # one iteration's least time: 48 env steps x 2,048 rows through the
    # policy in bf16, values on 2 x 98,304 rows and 2 epochs of the update
    # on 98,304 rows in fp32
    rows = {"sample": 48 * 2048, "values": 2 * 98304, "loss": 2 * 98304}
    m = t["macs"]
    want = (2 * (m["shared_head"] + m["policy"]) * 48 * 2048 / 989e12
            + 2 * (m["shared_head"] + m["critic"]) * 2 * 98304 / 67e12
            + 6 * sum(m.values()) * 2 * 98304 / 67e12)
    assert flops.least_time_s(example, rows) == pytest.approx(want)
    assert 0.085 < want < 0.1


def test_weights_match_the_program():
    import torch

    from perfbench import program
    _, _, cell, config = harness.spec("bench-2v2.train")
    config["env"]["num_envs"] = 2
    trainer = program.build(config, cell["traffic"], 3, "cpu")
    weights = harness.make_weights(config, 3, "cpu")
    trainer.learner.load_state_dict(weights, strict=True)
    again = harness.make_weights(config, 3, "cpu")
    assert all(torch.equal(weights[k], again[k]) for k in weights)


@pytest.mark.parametrize("where", ["config", "env", "traffic", "cell"])
def test_unknown_keys_are_refused(where, tmp_path, monkeypatch):
    from perfbench import program
    _, _, cell, config = harness.spec("example-2v2.skill16")
    program.check_keys(config, cell["traffic"])
    target = {"config": config, "env": config["env"],
              "traffic": cell["traffic"], "cell": cell}[where]
    target["not_a_key"] = 1
    with pytest.raises(SystemExit):
        if where == "cell":
            (tmp_path / "cells").mkdir()
            (tmp_path / "cells" / "example-2v2.skill16.json").write_text(
                json.dumps(cell))
            (tmp_path / "configs").symlink_to(harness.HERE / "configs")
            monkeypatch.setattr(harness, "HERE", tmp_path)
            harness.spec("example-2v2.skill16")
        else:
            program.check_keys(config, cell["traffic"])


def test_match_size_from_the_files():
    from perfbench import program
    _, _, cell, config = harness.spec("example-2v2.skill16")
    assert program.match_size(config, cell["traffic"]) == (675, 16)
    _, _, cell, config = harness.spec("example-2v2.train")
    assert program.match_size(config, cell["traffic"]) is None
