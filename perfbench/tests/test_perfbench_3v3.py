"""The cell ``example-3v3.train`` (Standard 3v3) on the CPU at the tests'
tiny size (2 arenas of 3v3, one env step an iteration): the port against
the frozen reference with the cell's own limits, traced and untraced, and
the result line's schema; ``correct`` false under the training faults
(``unchanged_state``, ``half_batch``) and under ``physics_altered`` and
``reward_altered``; the reader of ``arena_step.car_tick_ns`` on made-up
trace data.  A run takes about three minutes on one CPU thread: the plain
physics steps six cars."""

import importlib.util

import pytest

from conftest import shrink
from perfbench import faults, harness
from test_perfbench_run import SEED, check_schema

CELL = "example-3v3.train"


def reader():
    path = harness.HERE / "metrics" / "arena_step.car_tick_ns.py"
    spec = importlib.util.spec_from_file_location("car_tick_ns", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_traced_run_agrees_with_the_reference():
    result = harness.run(CELL, SEED, 0.0, True, "cpu", shrink=shrink)
    check_schema(result, CELL, True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["env.ops_per_step"]["value"] > 0
    assert "selfplay.match_s" not in result["metrics"]


def test_untraced_run_agrees_with_the_reference():
    result = harness.run(CELL, SEED + 1, 0.0, False, "cpu", shrink=shrink)
    check_schema(result, CELL, False)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "physics_altered", "reward_altered"])
def test_fault_makes_correct_false(fault):
    with faults.FAULTS[fault]():
        result = harness.run(CELL, SEED, 0.0, False, "cpu", shrink=shrink)
    assert not result["correct"], result["checks"]


def test_car_tick_reader_by_hand():
    read = reader().read
    config = {"env": {"num_envs": 512, "team_size": 3, "tick_skip": 8}}
    # two launches of 1 and 3 ms: 2 ms over 512 x 6 x 8 = 24,576 car-ticks
    t = {"training_launch_s": [1e-3, 3e-3], "config": config}
    assert read(t) == pytest.approx(2e6 / 24576)      # 81.38 ns
    config["env"]["team_size"] = 2                      # 16,384 at 2v2
    assert read(t) == pytest.approx(2e6 / 16384)
    # no launch in the trace (the CPU, or a kernel off the path): nothing
    assert read({"training_launch_s": [], "config": config}) is None
    assert read({"spans": {}}) is None

