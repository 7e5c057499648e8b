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
