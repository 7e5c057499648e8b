"""The port's data parallelism (``parallel/mesh.py``) on the CPU: gloo ranks
spawned as processes (``tests/torch_parallel_jobs.py``), held against the
unsharded port and the JAX package.

  * a sharded ``train_iteration`` on 2 and 4 ranks and on a 2 x 2 (host,
    env) mesh against the unsharded port, at tests/test_sharding.py's
    configuration and tolerances (params rtol 2e-4, atol 2e-5;
    ``reward_mean`` within 1e-4), every arena reset inside the iteration;
    the ranks' parameters bit-equal to each other;
  * the placement (each rank's obs is its block of the unsharded obs, the
    parameters are the unsharded ones), ``gather_train_state`` back to the
    unsharded state, the mesh's shape and axis names;
  * a weighted iteration against an old version over two minibatches;
  * the Welford merge over ranks against ``update_batch`` on the whole
    batch (float32 sums in another order: rtol 1e-6);
  * the sharded learning half (``Trainer.learn`` on 2 ranks, one arena
    each, with the JAX permutations) against the JAX package's, at
    tests/test_torch_learn.py's tolerances;
  * ``Trainer.train`` on the 2 x 2 mesh: rank 0 logs, reads the quit key (its
    answer stops every rank) and writes a checkpoint of every arena;
  * what raises: a mesh of another size, arenas the ranks do not divide,
    a resume after sharding, no card where the rank's device is CUDA;
    ``initialize_distributed`` with nothing set does nothing.

The jobs run in a few spawned groups, each with its own timeout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_learn as L
import torch_parallel_jobs as jobs
from reinforcement_learning_torch.learn import welford as twelford
from reinforcement_learning_torch.parallel import mesh as meshmod
from reinforcement_learning_tpu.learn import gae as jgae
from reinforcement_learning_tpu.learn import ppo as jppo
from reinforcement_learning_tpu.learn import welford as jwelford

torch.set_num_threads(1)

SHARDING = dict(rtol=2e-4, atol=2e-5)   # tests/test_sharding.py
REWARD_ATOL = 1e-4
MERGE = dict(rtol=1e-6, atol=1e-6)
LAYOUTS = {"2": (2, 0), "4": (4, 0), "2x2": (4, 2)}   # world, hosts
WEIGHTED_BATCH = 32          # 64 rows: two minibatches
JOB_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def welford_case():
    rng = np.random.RandomState(5)
    cases = {}
    for name, shape in (("scalar", ()), ("vector", (5,))):
        x = rng.normal(3.0, 2.0, (40,) + shape).astype(np.float32)
        start = (np.float32(50.0), np.full(shape, 0.3, np.float32),
                 np.full(shape, 400.0, np.float32))
        cases[name] = (x, start)
    return cases


@pytest.fixture(scope="module")
def learn_case():
    """test_torch_learn.test_learning_half_matches_jax's inputs and the JAX
    package's learning half on them (trainer.py:195-236)."""
    T, N, P = L.T, L.N, L.P
    env = L._trainer().env
    traj = L._trajectory(env.obs_size, env.num_actions)
    jl = jppo.PPOLearner(env.obs_size, env.num_actions,
                         jppo.PPOConfig(**L.SMALL))
    jstate = jl.init(jax.random.PRNGKey(3))
    p = jstate.params
    rs = jwelford.WelfordState(count=jnp.float32(50.0),
                               mean=jnp.float32(0.3), m2=jnp.float32(400.0))
    flat = lambda x: jnp.asarray(x).reshape((T * N * P,) + x.shape[3:])  # noqa
    v_obs = jl.values(p, flat(traj["obs"]), half=False)
    v_final = jl.values(p, flat(traj["final_obs"]), half=False)
    term_tb = jnp.repeat(jnp.asarray(traj["terminal"]), P,
                         axis=-1).reshape(T, N * P)
    advs, targets, returns, clip_portion = jgae.compute_gae(
        jnp.asarray(traj["reward"]).reshape(T, N * P), term_tb,
        v_obs.reshape(T, N * P), v_final.reshape(T, N * P), 0.99, 0.95,
        rs.std, 200.0)
    rs_new = jwelford.update_batch(rs, returns.reshape(-1))
    data = dict(obs=flat(traj["obs"]), mask=flat(traj["mask"]),
                action=flat(traj["action"]).astype(jnp.int32),
                old_logp=flat(traj["old_logp"]), advantage=advs.reshape(-1),
                target_value=targets.reshape(-1))
    key = jax.random.PRNGKey(11)
    jnew, jm = jl.update(jstate, data, key)
    want = dict(jm, reward_mean=np.mean(traj["reward"]),
                goal_rate=np.mean(traj["goal"]),
                touch_rate=np.mean(traj["touch"]),
                episode_terminals=np.sum(traj["terminal"] > 0),
                return_std=rs_new.std, reward_clip_portion=clip_portion,
                value_mean=jnp.mean(v_obs),
                **{f"reward/{k}": np.mean(v)
                   for k, v in traj["reward_components"].items()})
    payload = {"params": {"shared_head": L._np_tree(p.shared_head),
                          "policy": L._np_tree(p.policy),
                          "critic": L._np_tree(p.critic)},
               "traj": traj, "perms": L._jax_perms(key, 2, T * N * P),
               "return_stat": (np.float32(50.0), np.float32(0.3),
                               np.float32(400.0))}
    return payload, want, rs_new, jnew


@pytest.fixture(scope="module")
def run(tmp_path_factory, welford_case, learn_case):
    """(layout -> the ranks' results of the job on it, the
    unsharded references, the 2 x 2 job's checkpoint folder).  The three
    jobs start together and run while this process trains the unsharded
    references."""
    checkpoints = str(tmp_path_factory.mktemp("checkpoints"))
    started = {}
    for layout, (world, hosts) in LAYOUTS.items():
        payload = {"hosts": hosts}
        if layout == "2":
            payload.update(extra=True, weighted_batch=WEIGHTED_BATCH,
                           welford=welford_case, learn=learn_case[0])
        if layout == "2x2":
            payload["checkpoints"] = checkpoints
        started[layout] = jobs.start(
            world, tmp_path_factory.mktemp(f"dp{layout}"), payload)
    refs = (jobs.unsharded(),
            jobs.unsharded(batch_size=WEIGHTED_BATCH, weighted=True))
    return ({k: jobs.finish(v, JOB_TIMEOUT) for k, v in started.items()},
            refs, checkpoints)


@pytest.fixture(scope="module")
def reference(run):
    return run[1][0]


@pytest.fixture(scope="module")
def weighted_reference(run):
    return run[1][1]


def _assert_params(got, want, tol, what):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{what}: {k}")


def _assert_bit_equal(ranks, key):
    for r, res in enumerate(ranks[1:], 1):
        for k, v in ranks[0][key].items():
            assert np.array_equal(res[key][k], v), f"rank {r} {key} {k}"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_shape_and_axes(run, layout):
    world, hosts = LAYOUTS[layout]
    shape, names, env_pl, rep_pl = run[0][layout][0]["mesh"]
    if hosts:
        assert shape == (hosts, world // hosts)
        assert names == (meshmod.HOST_AXIS, meshmod.ENV_AXIS)
    else:
        assert shape == (world,) and names == (meshmod.ENV_AXIS,)
    assert env_pl == ["S(0)"] * len(shape) and rep_pl == ["R"] * len(shape)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_iteration_matches_unsharded(run, reference, layout):
    """Parameters and reward_mean at tests/test_sharding.py's tolerances,
    every metric near the unsharded one, the counters global, the ranks'
    parameters and statistics bit-equal."""
    ranks = run[0][layout]
    assert reference["metrics"]["episode_terminals"] > 0
    for res in ranks:
        _assert_params(res["params"], reference["params"], SHARDING,
                       f"{layout} params")
        assert abs(res["metrics"]["reward_mean"]
                   - reference["metrics"]["reward_mean"]) < REWARD_ATOL
        assert set(res["metrics"]) == set(reference["metrics"])
        for k, v in reference["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-3,
                                       atol=1e-5, err_msg=k)
        assert res["counters"] == reference["counters"]
        np.testing.assert_allclose(res["return_stat"],
                                   reference["return_stat"], rtol=1e-5)
    _assert_bit_equal(ranks, "params")
    assert all(r["return_stat"] == ranks[0]["return_stat"] for r in ranks)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_placement(run, reference, layout):
    """Rank r holds arenas [r E/W, (r+1) E/W) (row-major over a 2-D
    mesh): its obs is exactly that block of the unsharded obs, and its
    parameters are the unsharded ones."""
    ranks = run[0][layout]
    obs = reference["state0"]["obs."]
    per = jobs.E // len(ranks)
    for r, res in enumerate(ranks):
        assert res["block"] == (r * per, per)
        assert np.array_equal(res["obs0"], obs[r * per:(r + 1) * per])
        for k, v in reference["params0"].items():
            assert np.array_equal(res["params0"][k], v), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gather_train_state(run, reference, layout):
    """Gathered right after sharding, the state is the unsharded one bit
    for bit; after the iteration it is the unsharded run's end state
    (floats at the parameters' tolerance)."""
    for res in run[0][layout]:
        for got, want in ((res["gathered0"], reference["state0"]),
                          (res["gathered"], reference["state"])):
            assert set(got) == set(want)
            for k, w in want.items():
                if got is res["gathered0"] or not np.issubdtype(
                        np.asarray(w).dtype, np.floating):
                    assert np.array_equal(got[k], w), k
                else:
                    np.testing.assert_allclose(got[k], w, **SHARDING,
                                               err_msg=k)


def test_weighted_iteration_matches_unsharded(run, weighted_reference):
    """Against an old version on team 1 (its rows weighted 0), two
    minibatches whose rows the ranks split unevenly."""
    ranks = run[0]["2"]
    for res in ranks:
        _assert_params(res["weighted_params"], weighted_reference["params"],
                       SHARDING, "weighted params")
        for k, v in weighted_reference["metrics"].items():
            np.testing.assert_allclose(res["weighted_metrics"][k], v,
                                       rtol=1e-3, atol=1e-5, err_msg=k)
    _assert_bit_equal(ranks, "weighted_params")


def test_welford_merge_over_ranks(run, welford_case):
    for name, (x, start) in welford_case.items():
        st = twelford.WelfordState(*(torch.tensor(v) for v in start))
        want = twelford.update_batch(st, torch.from_numpy(x))
        for res in run[0]["2"]:
            for got, w in zip(res["welford"][name],
                              (want.count, want.mean, want.m2)):
                np.testing.assert_allclose(got, w.numpy(), **MERGE,
                                           err_msg=name)


def test_sharded_learning_half_matches_jax(run, learn_case):
    """test_torch_learn.test_learning_half_matches_jax on 2 ranks: the
    metrics, the return statistic and the parameters after the update
    against the JAX package's, at that test's tolerances."""
    _, want, rs_new, jnew = learn_case
    ranks = run[0]["2"]
    for res in ranks:
        metrics = res["learn_metrics"]
        assert set(metrics) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(metrics[k], float(w), **L.GRAD,
                                       err_msg=k)
        for got, name in zip(res["learn_return_stat"],
                             ("count", "mean", "m2")):
            np.testing.assert_allclose(got, np.asarray(getattr(rs_new,
                                                               name)),
                                       **L.EXACT, err_msg=name)
        assert res["learn_counters"] == (L.T * L.N * L.P, 1)
        for name in L.MODELS:
            L._assert_trees(res["learn_params"][name],
                            getattr(jnew.params, name), L.PARAMS,
                            f"param {name}")
    for name in L.MODELS:
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(ranks[0]["learn_params"][name]),
            jax.tree.leaves(ranks[1]["learn_params"][name])))


def test_train_logs_stops_and_saves_on_rank_0(run):
    """``Trainer.train`` on the 2 x 2 mesh: rank 0 alone logs and reads
    the quit key, whose answer stops every rank after the first of 3
    iterations; the checkpoint rank 0 writes holds every arena; resuming
    after sharding raises."""
    from reinforcement_learning_torch.utils import checkpoint as ckpt
    ranks = [r["train"] for r in run[0]["2x2"]]
    assert [r["logs"] for r in ranks] == [[1], [], [], []]
    assert [r["stops"] for r in ranks] == [1, 0, 0, 0]
    assert all(r["iterations"] == 1 and r["resume_raises"] for r in ranks)
    r0 = run[0]["2x2"][0]
    folder = run[2]
    assert ckpt._numbered_dirs(folder) == [64]
    snap = torch.load(f"{folder}/64/state.pt", weights_only=True)
    np.testing.assert_array_equal(snap["state"]["obs."].numpy(),
                                  r0["train"]["obs"])
    assert snap["state"]["obs."].shape[0] == jobs.E


def test_mismatches_raise(run):
    """A mesh whose size is not the world's, and arenas the ranks do not
    divide, raise; nothing is accepted quietly."""
    for res in run[0]["2"]:
        for what, msg in res["raises"].items():
            assert msg is not None, f"{what} did not raise"


def test_initialize_distributed_needs_its_device(monkeypatch):
    """With no variable and no argument it does nothing and returns False
    (the JAX package's single-process path); asked for a process group on
    the default device without a card, it raises instead of taking the
    CPU; a mesh without a process group raises."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert meshmod.initialize_distributed() is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshmod.initialize_distributed("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="process group"):
        meshmod.make_mesh()
