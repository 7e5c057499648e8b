"""Data parallelism (``parallel/mesh.py``) on the card: the main path
(``initialize_distributed`` -> ``make_mesh`` -> ``shard_train_state`` ->
``Trainer.train_iteration`` at bench shape) in spawned ranks against the
unsharded run from the same seed.

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).  The ranks are ``torch_parallel_jobs.bench_iteration_job``,
started through ``torch_parallel_jobs.start`` with a ``FileStore``:

- one NCCL rank holding all 1024 arenas;
- two gloo ranks sharing the card (NCCL refuses two ranks on one card),
  512 arenas each, their parameters bit-equal to each other, and the
  kernel against the plain version on rank 0's end state.

Each rank launches the kernel 24 times in its iteration; every parameter
is within tests/test_sharding.py's tolerance (rtol 2e-4, atol 2e-5) of the
unsharded run's, ``reward_mean`` within 1e-4, every metric of the
iteration and the return statistic within rtol 1e-3, atol 1e-5, the step
count exact.
"""

from __future__ import annotations

import pytest
import torch

import torch_parallel_jobs as jobs
from bench_torch import bench_trainer
from torch_card import E, SEED, T, card, compare

DP_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_sharding.py's
DP_REWARD_ATOL = 1e-4
# the iteration's metrics and return statistic, as test_torch_parallel.py
# holds them: a wrong denominator or a doubled all-reduce scales the
# gradient, which the global-norm clip and Adam leave out of the
# parameters, but not out of the losses
DP_METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
DP_TIMEOUT = 300.0   # s, a job of ranks, from their start


@pytest.fixture(scope="module")
def unsharded(card):
    """The unsharded run's first iteration from the seed."""
    trainer = bench_trainer(E, "soccar", SEED)
    state, metrics = trainer.train_iteration(trainer.init(SEED))
    return jobs.iteration_result(trainer, state, metrics)


def run_ranks(world, backend, folder, end=False):
    started = jobs.start(world, folder, {"arenas": E, "seed": SEED,
                                         "end": end},
                         job=jobs.bench_iteration_job, device="cuda",
                         backend=backend)
    return jobs.finish(started, DP_TIMEOUT)


def assert_agrees(res, first):
    assert res["launches"] == T
    off = [k for k, w in first["params"].items()
           if not bool(((res["params"][k] - w).abs()
                        <= DP_TOL["atol"] + DP_TOL["rtol"] * w.abs()).all())]
    assert off == [], f"parameters beyond {DP_TOL} of the unsharded run"
    got, want = res["metrics"], first["metrics"]
    assert abs(got["reward_mean"] - want["reward_mean"]) < DP_REWARD_ATOL
    assert set(got) == set(want)
    pairs = {**{k: (got[k], v) for k, v in want.items()},
             **{f"return_stat.{k}": (a, b) for k, a, b in zip(
                 ("count", "mean", "m2"), res["return_stat"],
                 first["return_stat"])}}
    off = {k: (a, b) for k, (a, b) in pairs.items()
           if not abs(a - b) <= (DP_METRIC_TOL["atol"]
                                 + DP_METRIC_TOL["rtol"] * abs(b))}
    assert off == {}, f"beyond {DP_METRIC_TOL} of the unsharded run"
    assert res["total_timesteps"] == first["total_timesteps"]


@pytest.mark.card
def test_one_nccl_rank_equals_unsharded(unsharded, tmp_path):
    (res,) = run_ranks(1, "nccl", tmp_path)
    assert_agrees(res, unsharded)


@pytest.mark.card
def test_two_gloo_ranks_equal_unsharded(unsharded, tmp_path):
    ranks = run_ranks(2, "gloo", tmp_path, end=True)
    for res in ranks:
        assert_agrees(res, unsharded)
    assert [k for k, v in ranks[0]["params"].items()
            if not torch.equal(v, ranks[1]["params"][k])] == []
    got, want = ranks[0]["end"]
    compare(got, want, 1)
