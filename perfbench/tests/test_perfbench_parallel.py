"""The data-parallel path of the harness on the CPU: a cell's run on 2 gloo
ranks at the tests' tiny size (``perfbench/launch.py`` starting
``perfbench/rank.py`` twice) against the frozen reference with the cell's
own limits, ``correct`` false for each fault such a cell can have, planted
under the timed path in the ranks, and the launcher ending a run whose
ranks die or hang, within its timeout."""

import json
import sys
import time

import pytest

from perfbench import launch

SEED = 2 ** 31 + 7   # the tests' seed (test_perfbench_run.py)
WORKLOAD = "bench-2v2.dp4"
TIMEOUT = 600.0


def sharded(trace: bool, fault: str = "") -> dict:
    args = ["--workload", WORKLOAD, "--seeds", str(SEED), "--seconds", "0",
            "--trace", str(int(trace)), "--launched-at", repr(time.time()),
            "--device", "cpu",
            "--shrink", "perfbench.tests.conftest:shrink_two_ranks"]
    if fault:
        args += ["--fault", fault]
    ok, codes, outs, errs, why = launch.run_ranks(2, args, TIMEOUT)
    assert ok, (why, codes, errs[0][-3000:], errs[1][-3000:])
    return json.loads(outs[0].splitlines()[-1])


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    # each rank and the reference on one thread: the same rounding in every
    # run (the tiny size's chained iterations amplify it)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("trace", [False, True])
def test_sharded_run_agrees_with_the_reference(trace):
    from test_perfbench_run import check_schema
    result = sharded(trace)
    check_schema(result, WORKLOAD, trace)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 2
    assert result["checks"]["replica_gap"]["value"] == 0
    assert result["checks"]["rank_steps_off"]["value"] == 0
    assert result["checks"]["draw_off"]["value"] == 0
    if trace:
        # two gradient all-reduces and the batch statistics' each iteration
        assert result["metrics"]["parallel.all_sum_calls"]["value"] >= 2
    else:
        # 2 ranks x 2 arenas x 4 players, two env steps an iteration
        steps = result["metrics"]["player_steps_per_s"]["value"]
        assert steps > 0


# the faults a data-parallel training cell can have: the exchange between
# the ranks left out, one rank's window cut short, one rank keeping its
# neighbour's block of the draws, a step that returns its state unchanged,
# half of the batch left out, an answer altered where it is produced (the
# kernel's next state, the env's reward)
FAULTS = ["rank_skips_allreduce", "rank_short_window",
          "rank_keeps_neighbours_block", "unchanged_state", "half_batch",
          "physics_altered", "reward_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_makes_correct_false(fault):
    result = sharded(False, fault)
    assert not result["correct"], result["checks"]
    if fault == "rank_skips_allreduce":
        assert result["checks"]["replica_gap"]["value"] > 0
    if fault == "rank_short_window":
        assert result["checks"]["rank_steps_off"]["value"] == 1
    if fault == "rank_keeps_neighbours_block":
        assert result["checks"]["draw_off"]["value"] > 0


def read_metric(name: str, data: dict):
    import importlib.util
    from pathlib import Path
    path = Path(launch.ROOT, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("metric", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(data)


def test_allreduce_readers_take_each_kernels_least_and_its_spread():
    # 3 ranks, 2 all-reduce kernels each, seconds in rank order
    data = {"allreduce_launches": [[0.004, 0.010], [0.001, 0.030],
                                   [0.002, 0.011]]}
    assert read_metric("parallel.allreduce_ms", data) == pytest.approx(11.0)
    assert read_metric("parallel.allreduce_skew_ms",
                       data) == pytest.approx(3.0 + 20.0)
    for empty in ({}, {"allreduce_launches": [[], []]},
                  {"allreduce_launches": [[0.001], [0.001, 0.002]]}):
        assert read_metric("parallel.allreduce_ms", empty) is None
        assert read_metric("parallel.allreduce_skew_ms", empty) is None


def test_the_ranks_timeout_grows_with_the_window_and_the_trace():
    base = launch.run_timeout(10, False)
    assert launch.run_timeout(50, False) == base + 40
    assert launch.run_timeout(10, True) > base


def stub(code: str) -> list:
    return [sys.executable, "-c", "import os, signal, time\n"
            "rank = int(os.environ['RANK'])\n" + code]


def test_a_rank_that_dies_ends_the_run():
    t0 = time.monotonic()
    ok, codes, _, _, why = launch.run_ranks(2, [], 120.0, command=stub(
        "if rank == 1:\n"
        "    time.sleep(1.0)\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "time.sleep(600)\n"))
    assert not ok and codes[1] == -9 and codes[0] is None, (codes, why)
    assert "rank 1" in why
    assert time.monotonic() - t0 < 60


def test_ranks_that_hang_end_at_the_timeout():
    t0 = time.monotonic()
    ok, codes, _, errs, why = launch.run_ranks(2, [], 3.0, command=stub(
        "print('waiting', rank, flush=True)\n"
        "time.sleep(600)\n"))
    assert not ok and codes == [None, None], (codes, why)
    assert "outlasted" in why
    assert time.monotonic() - t0 < 30


def test_every_rank_exits_zero():
    ok, codes, outs, _, _ = launch.run_ranks(2, [], 60.0, command=stub(
        "print('rank', rank, os.environ['WORLD_SIZE'])\n"))
    assert ok and codes == [0, 0]
    assert [o.split() for o in outs] == [["rank", "0", "2"],
                                         ["rank", "1", "2"]]
