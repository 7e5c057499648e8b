"""On the card: the control (the reference in the next precision below
the configuration's, in the program's place) comes out as not correct
under each cell's limits, on three seeds, at a size a test run holds
(64 arenas, the cells' widths); and sound readings at that size come out
correct.  Skips without a card."""

import pytest

from perfbench import harness, readings


def small(config, cell):
    config["env"]["num_envs"] = 64
    config["trainer"]["ts_per_itr"] = 64 * 4 * 8


@pytest.mark.card
@pytest.mark.parametrize("workload", ["example-2v2.train",
                                      "bench-2v2.train"])
def test_control_fails_and_program_passes(card, workload):
    _, _, cell, _ = harness.spec(workload)
    limits = cell["limits"]
    for seed in (1, 2, 3):
        r = readings.reading(workload, seed, card, control=True,
                             shrink=small)
        assert all(v <= limits[k] for k, v in r["numbers"].items()), r
        assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.card
def test_data_parallel_control_fails_and_program_passes(card):
    """The same for the 4-card cell, its ranks at 64 arenas each."""
    import json
    import time

    import torch

    from perfbench import launch
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    workload = "bench-2v2.dp4"
    limits = harness.spec(workload)[2]["limits"]
    harness.load_kernel(card)   # built once, before the ranks load it
    ok, codes, outs, errs, why = launch.run_ranks(4, [
        "--workload", workload, "--seeds", "1,2,3", "--seconds", "0",
        "--trace", "0", "--launched-at", repr(time.time()), "--control",
        "--shrink", "perfbench.tests.test_perfbench_card:small"], 600.0)
    assert ok, (why, codes, errs[0][-3000:])
    results = [json.loads(line) for line in outs[0].splitlines()
               if line.startswith("{")]
    assert len(results) == 3
    for r in results:
        assert r["correct"], r["checks"]
        assert any(v > limits[k] for k, v in r["control"].items()), r
