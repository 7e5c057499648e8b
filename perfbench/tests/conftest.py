"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``
from the root of the repository.  Tests marked ``card`` need a CUDA card
and skip without one; run them on the card with the same command."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def shrink(config, cell):
    """The CPU tests' tiny sizes: 2 arenas, one env step an iteration, a
    skill match of 3 env steps every 2 iterations."""
    config["env"]["num_envs"] = 2
    config["trainer"]["ts_per_itr"] = 8
    if cell["traffic"].get("match_sim_seconds"):
        cell["traffic"]["match_sim_seconds"] = 0.2
        cell["traffic"]["skill_interval"] = 2
