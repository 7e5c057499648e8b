"""The port's tracer (``reinforcement_learning_torch/utils/tracing.py``):
off it records no span and annotates nothing; on, the spans nest where the
work happens, the counters count it, and ``Trainer.train`` hands the
operator its ``timing/*`` and ``count/*`` keys.  A tiny self-play trainer on
the CPU (2 arenas of 1v1, 2 env steps an iteration, a skill match of 2
steps every iteration), its physics a stand-in that returns the state it is
given: the spans, not the physics, are under test here."""

from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from reinforcement_learning_torch.envs import env as tenv
from reinforcement_learning_torch.envs.shard import EnvShard
from reinforcement_learning_torch.learn import ppo as tppo
from reinforcement_learning_torch.learn import selfplay as tsp
from reinforcement_learning_torch.learn import trainer as ttrainer
from reinforcement_learning_torch.physics import step as tstep
from reinforcement_learning_torch.utils import tracing

torch.set_num_threads(1)

T, MATCH_STEPS, N, P = 2, 2, 2, 2
SMALL = dict(policy_layers=(8, 8), critic_layers=(8,),
             shared_head_layers=(8,), half_precision=False, batch_size=8,
             epochs=2)
STEP_PHASES = ("env.parse", "env.physics", "env.post")
POST_PHASES = ("env.post.events", "env.post.terminals", "env.post.rewards",
               "env.post.obs", "env.post.reset_draw", "env.post.masks")
ITERATION_SPANS = {"iter", "iter.collect", "policy.sample", *STEP_PHASES,
                   *POST_PHASES, "iter.learn", "iter.prepare",
                   "prepare.values", "prepare.gae", "prepare.welford",
                   "iter.update", "update.epoch", "match"}
SETUP_SPANS = {"setup.env", "setup.trainer"}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts with the process-wide tracer's counters at zero
    and leaves it off and empty."""
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _enclosing(record) -> list:
    """The names of the spans around ``record``, innermost first."""
    out, parent = [], record.parent
    while parent is not None:
        out.append(parent.name)
        parent = parent.parent
    return out


@pytest.fixture(scope="module")
def runs():
    """The trainer built with the tracer on, one ``Trainer.train``
    iteration with it off, then one with it on; what ``log_fn`` saw in
    each (the metrics, and the tracer's records and summary before
    ``train`` clears them)."""
    seen = {}

    def log(label):
        def fn(_, metrics):
            seen[label] = types.SimpleNamespace(
                metrics=metrics, records=list(tracing._records),
                summary=tracing.summary())
        return fn

    tracing.reset()
    tracing.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tenv, "arena_step", lambda phys, *a, **kw: phys)
            params = tstep.ArenaParams(num_cars=P, use_mesh=False,
                                       dynamic_wheel_rays=False)
            env = tenv.RocketLeagueEnv(tenv.EnvConfig(
                num_envs=N, team_size=1, arena=params, device="cpu"))
            skill = tsp.SkillTrackerConfig(
                enabled=True, num_arenas=N, update_interval=1,
                sim_time=MATCH_STEPS * env.config.step_seconds)
            trainer = ttrainer.Trainer(
                env, tppo.PPOConfig(**SMALL),
                ttrainer.TrainerConfig(ts_per_itr=T * N * P, random_seed=3),
                selfplay=tsp.SelfPlayConfig(train_against_old_chance=0.0,
                                            skill=skill))
            setup = tracing.summary()["spans"]
            tracing.disable()
            tracing.reset()
            state = trainer.init(0)
            state = trainer.train(state, 1, log_fn=log("off"))
            tracing.reset()
            tracing.enable()
            trainer.train(state, 1, log_fn=log("on"))
            seen["on_left"] = tracing.summary()
    finally:
        tracing.disable()
        tracing.reset()
    return types.SimpleNamespace(setup=setup, **seen)


def test_off_records_no_span_and_no_timing_keys(runs):
    assert runs.off.summary["spans"] == {}
    assert not runs.off.records
    assert not any(k.startswith(("timing/", "count/"))
                   for k in runs.off.metrics)
    # counters count with the spans off, for chip_smoke's checks
    assert runs.off.summary["counters"]["env.steps"] == T + MATCH_STEPS


def test_off_span_opens_no_annotation_and_on_does():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("off.span"):
            pass
        tracing.enable()
        with tracing.span("on.span"):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "on.span" in names and "off.span" not in names


def test_train_clears_the_tracer_after_each_iteration(runs):
    assert runs.on_left == {"spans": {}, "counters": {}}


def test_setup_spans_and_the_match_env_nested(runs):
    assert set(runs.setup) == SETUP_SPANS
    # the trainer builds the skill match's env inside its own set-up
    assert runs.setup["setup.env"]["calls"] == 2
    assert runs.setup["setup.trainer"]["calls"] == 1


def test_each_env_step_nests_under_the_collection_or_the_match(runs):
    by_parent = {}
    for r in runs.on.records:
        if r.name in STEP_PHASES + ("policy.sample",):
            around = _enclosing(r)
            where = ("match" if "match" in around else
                     "collect" if "iter.collect" in around else None)
            by_parent[r.name, where] = by_parent.get((r.name, where), 0) + 1
    want = {(name, "collect"): T for name in STEP_PHASES}
    want.update({(name, "match"): MATCH_STEPS for name in STEP_PHASES})
    # the current policy each step, and the old version's in the match
    want.update({("policy.sample", "collect"): T,
                 ("policy.sample", "match"): 2 * MATCH_STEPS})
    assert by_parent == want
    for r in runs.on.records:
        if r.name in STEP_PHASES:
            assert r.parent.name in ("iter.collect", "match")


def test_post_phases_cover_env_post(runs):
    spans = runs.on.summary["spans"]
    steps = T + MATCH_STEPS
    for name in POST_PHASES:
        calls = 2 * steps if name == "env.post.obs" else steps
        assert spans[name]["calls"] == calls, name
    post = spans["env.post"]
    covered = sum(spans[name]["total_ms"] for name in POST_PHASES)
    assert post["self_ms"] == pytest.approx(post["total_ms"] - covered,
                                            abs=1e-6)
    assert post["self_ms"] < 0.2 * post["total_ms"]


def test_one_iteration_under_one_root(runs):
    spans = runs.on.summary["spans"]
    assert set(spans) == ITERATION_SPANS
    assert spans["iter"]["calls"] == 1
    roots = {r.name for r in runs.on.records if r.parent is None}
    assert roots == {"iter"}
    learn = spans["iter.learn"]
    assert learn["total_ms"] == pytest.approx(
        spans["iter.prepare"]["total_ms"] + spans["iter.update"]["total_ms"]
        + learn["self_ms"])
    assert spans["update.epoch"]["calls"] == SMALL["epochs"]


def test_counters_on_the_cpu(runs):
    c = runs.on.summary["counters"]
    assert c["env.steps"] == T + MATCH_STEPS
    assert "kernel.launches" not in c and "kernel.builds" not in c
    assert c["policy.rows"] == (T + 2 * MATCH_STEPS) * N * P
    assert c["critic.rows"] == 2 * T * N * P          # stored and final obs
    assert c["update.rows"] == SMALL["epochs"] * T * N * P
    assert "shard.all_sum.calls" not in c             # unsharded


def test_device_ms_absent_on_the_cpu(runs):
    spans = runs.on.summary["spans"]
    assert all("device_ms" not in s for s in spans.values())


def test_timing_block_reads_every_span_and_counter(runs):
    m, s = runs.on.metrics, runs.on.summary
    timing = {k for k in m if k.startswith("timing/")}
    assert timing == {f"timing/{name}_ms" for name in s["spans"]}
    assert all(m[f"timing/{name}_ms"] == v["total_ms"]
               for name, v in s["spans"].items())
    assert {k for k in m if k.startswith("count/")} == {
        f"count/{name}" for name in s["counters"]}
    assert m["count/env.steps"] == T + MATCH_STEPS


def test_self_time_on_a_synthetic_nesting(monkeypatch):
    """outer [0, 100] holds a [10, 30] and b [40, 70], b holds c [50, 60]
    (ns on a clock the test drives)."""
    ticks = iter([0, 10, 30, 40, 50, 60, 70, 100])
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("a"):
            pass
        with tracing.span("b"):
            with tracing.span("c"):
                pass
    spans = tracing.summary()["spans"]
    ms = {k: (v["total_ms"] * 1e6, v["self_ms"] * 1e6)
          for k, v in spans.items()}
    assert ms == {"outer": (100, 50), "a": (20, 20), "b": (30, 20),
                  "c": (10, 10)}
    tracing.reset()
    assert tracing.summary() == {"spans": {}, "counters": {}}


def test_off_span_is_one_shared_noop_and_counters_count():
    assert not tracing.enabled()
    first, second = tracing.span("a"), tracing.span("b")
    assert first is second
    with first:
        tracing.count("n", 5)
    assert tracing.summary() == {"spans": {}, "counters": {"n": 5}}


def test_traced_method_is_a_span_only_when_on():
    class Thing:
        device = "cpu"

        @tracing.traced("thing.work", device="device")
        def work(self, x):
            return x + 1

    thing = Thing()
    assert thing.work(1) == 2
    assert tracing.summary()["spans"] == {}
    tracing.enable()
    assert thing.work(2) == 3
    spans = tracing.summary()["spans"]
    assert spans["thing.work"]["calls"] == 1
    assert "device_ms" not in spans["thing.work"]


def test_all_sum_counts_what_it_reduces(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group: calls.append(group))
    sharded = EnvShard(8, 0, 4, groups=("inner", "outer"))
    tracing.reset()
    sharded.all_sum(torch.zeros(3))
    sharded.all_sum(torch.zeros(2, dtype=torch.float64))
    EnvShard(8).all_sum(torch.zeros(5))               # unsharded: no-op
    assert calls == ["inner", "outer"] * 2
    assert tracing.summary()["counters"] == {"shard.all_sum.calls": 2,
                                             "shard.all_sum.bytes": 12 + 16}
