"""Whole runs of the harness on the CPU at a tiny size (2 arenas, one env
step an iteration): the port's CPU path against the frozen reference with
each cell's own limits, the result line's schema, and ``correct`` false
for each fault the cells can have, planted under the timed path."""

import json
import math

import pytest

from conftest import shrink
from perfbench import faults, harness

SEED = 2 ** 31 + 7   # beyond 32 signed bits, as a run's seed may be


def check_schema(result: dict, workload: str, trace: bool):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
        names = {m["name"]: m for m in bench["per_layer"]}
    else:
        names = {m["name"]: m for m in bench["end_to_end"]}
        assert set(result["metrics"]) == set(names)
    for name, m in result["metrics"].items():
        assert m["unit"] == names[name]["unit"]
        assert math.isfinite(m["value"])
        assert workload in names[name].get("workloads", [workload])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("workload,trace", [("bench-2v2.train", False),
                                            ("example-2v2.skill16", True)])
def test_port_agrees_with_the_reference(workload, trace):
    result = harness.run(workload, SEED, 0.0, trace, "cpu", shrink=shrink)
    check_schema(result, workload, trace)
    assert result["correct"], result["checks"]
    if trace:
        assert result["metrics"]["env.ops_per_step"]["value"] > 0
        assert "selfplay.match_s" in result["metrics"]
        assert {"elo_gap", "match_off"} <= set(result["checks"])


# the faults a cell can have, on the cell that has them
FAULTED = [("bench-2v2.train", f) for f in (
    "unchanged_state", "half_batch", "physics_unchanged", "physics_altered",
    "reward_altered", "logp_altered", "values_bf16",
    "return_stat_unchanged")] + [("example-2v2.skill16", f) for f in (
    "elo_altered", "match_shortened")]


@pytest.mark.parametrize("workload,fault", FAULTED)
def test_fault_makes_correct_false(workload, fault):
    with faults.FAULTS[fault]():
        result = harness.run(workload, SEED, 0.0, False, "cpu",
                             shrink=shrink)
    assert not result["correct"], result["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "bench-2v2.train", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_a_cell_with_a_save_cadence_saves_in_the_window(tmp_path,
                                                         monkeypatch):
    def saving(config, cell):
        shrink(config, cell)
        cell["traffic"]["ts_per_save"] = 1
    monkeypatch.setattr(harness, "CHECKPOINTS", tmp_path)
    result = harness.run("bench-2v2.train", SEED, 0.0, False, "cpu",
                         shrink=saving)
    assert result["correct"], result["checks"]
    assert any((tmp_path / "bench-2v2.train").iterdir())
