"""The rank side of tests/test_torch_parallel.py: the job that a test
spawns as gloo ranks on the CPU, each rank writing its results to a file.  This
module imports torch and the port only (no JAX), so that a spawned rank
starts quickly; the tests hold the results against the unsharded port and
the JAX package.

``start(world, folder, payload)`` starts ``world`` ranks of
``iterate_job`` with a ``FileStore`` in ``folder`` (no TCP port, so parallel
test workers cannot collide); ``finish(started, timeout)`` returns each
rank's result, and kills them all if they outlast ``timeout`` seconds.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.learn import welford
from reinforcement_learning_torch.learn.ppo import PPOConfig, PPOLearner
from reinforcement_learning_torch.learn.trainer import Trainer, TrainerConfig
from reinforcement_learning_torch.parallel import mesh as meshmod
from reinforcement_learning_torch.physics import step as stepmod
from reinforcement_learning_torch.utils import checkpoint as ckpt

# tests/test_sharding.py's configuration: 8 arenas x 1v1 at full fidelity,
# 32-wide trio, batch 4096, one epoch, 64 player-steps (4 env steps) per
# iteration, fp32; episodes cut at 3 env steps, so that every arena resets
# inside the iteration (a draw made at the wrong shape shows there)
E = 8
EPISODE_SECONDS = 3 * 8 / 120


def sharding_trainer(batch_size: int = 4096,
                     checkpoint_folder: str = "") -> Trainer:
    env = RocketLeagueEnv(EnvConfig(num_envs=E, team_size=1, device="cpu",
                                    max_episode_seconds=EPISODE_SECONDS))
    ppo = PPOConfig(policy_layers=(32, 32), critic_layers=(32, 32),
                    shared_head_layers=(32,), batch_size=batch_size,
                    epochs=1, half_precision=False)
    return Trainer(env, ppo, TrainerConfig(
        ts_per_itr=64, checkpoint_folder=checkpoint_folder))


def opponent_of(trainer: Trainer, seed: int = 7) -> dict:
    """Another version's parameters, as ``sample_actions(params=...)``
    takes them."""
    other = PPOLearner(trainer.env.obs_size, trainer.env.num_actions,
                       trainer.ppo_config, device="cpu", seed=seed)
    return {name: {k: v.detach() for k, v in
                   getattr(other, name).named_parameters()}
            for name in ("policy", "shared_head")}


def weighted_iteration(trainer: Trainer, state):
    """One iteration against an old version on team 1, its rows weighted
    0 (``train_iteration`` with ``use_old``)."""
    return trainer._train_iteration(state, opponent_of(trainer), old_team=1,
                                    use_old=True)


# tests/test_torch_learn.py's learning half: 2 arenas x 2v2 on the plane
# arena, 3 steps, 16-wide trio, batch 10 (two minibatches of 12 rows)
LEARN_T, LEARN_N, LEARN_P = 3, 2, 4
LEARN_PPO = dict(policy_layers=(16, 16), critic_layers=(16, 16),
                 shared_head_layers=(16,), half_precision=False,
                 batch_size=10, epochs=2)


def learn_trainer() -> Trainer:
    env = RocketLeagueEnv(EnvConfig(
        num_envs=LEARN_N, team_size=LEARN_P // 2, device="cpu",
        arena=stepmod.ArenaParams(num_cars=LEARN_P, use_mesh=False,
                                  dynamic_wheel_rays=False)))
    return Trainer(env, PPOConfig(**LEARN_PPO),
                   TrainerConfig(ts_per_itr=LEARN_T * LEARN_N * LEARN_P,
                                 random_seed=1))


def params_np(learner) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in learner.state_dict().items()}


def metrics_np(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def state_np(state) -> dict:
    return {k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
            for k, v in ckpt.flatten(state).items()}


def _raises(fn) -> str | None:
    """The message of the ValueError ``fn`` raises, None if it does not."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# the job: (rank, world, payload) -> a picklable result

def iterate_job(rank, world, payload):
    """Shard ``sharding_trainer``'s state over a 1-D mesh or a (host, env)
    mesh, gather it back, and train one iteration; with ``extra``, the
    mesh checks, a weighted iteration, the Welford merge and the learning
    half against the JAX package's."""
    out = {}
    if payload["hosts"]:
        mesh = meshmod.make_host_mesh(payload["hosts"],
                                      world // payload["hosts"])
    else:
        mesh = meshmod.make_mesh(world)
    out["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names,
                   [str(p) for p in meshmod.env_sharding(mesh)],
                   [str(p) for p in meshmod.replicated(mesh)])
    trainer = sharding_trainer()
    state = meshmod.shard_train_state(trainer, trainer.init(0), mesh)
    shard = trainer.env.shard
    out["block"] = (shard.offset, shard.local_envs)
    out["obs0"] = state.obs.numpy().copy()
    out["params0"] = params_np(trainer.learner)
    out["gathered0"] = state_np(meshmod.gather_train_state(trainer, state))
    state, metrics = trainer.train_iteration(state)
    out["params"] = params_np(trainer.learner)
    out["metrics"] = metrics_np(metrics)
    out["counters"] = (state.total_timesteps, state.iterations)
    out["return_stat"] = [float(x) for x in (state.return_stat.count,
                                             state.return_stat.mean,
                                             state.return_stat.m2)]
    out["gathered"] = state_np(meshmod.gather_train_state(trainer, state))
    if payload.get("extra"):
        out.update(_extra(rank, world, mesh, payload))
    if payload.get("checkpoints"):
        out.update(_train(mesh, payload["checkpoints"]))
    return out


def _train(mesh, folder):
    """``Trainer.train`` for 3 iterations: rank 0 alone logs and answers
    the quit key (True after the first), every rank stops there, and rank
    0 writes the whole state; a resume after sharding raises."""
    trainer = sharding_trainer(checkpoint_folder=folder)
    state = meshmod.shard_train_state(trainer, trainer.init(0), mesh)
    logs, stops = [], []
    state = trainer.train(state, 3, log_fn=lambda i, m: logs.append(i),
                          stop_fn=lambda: stops.append(1) or True)
    return {"train": {
        "logs": logs, "stops": len(stops), "iterations": state.iterations,
        "obs": meshmod.gather_train_state(trainer, state).obs.numpy().copy(),
        "resume_raises": _raises(trainer.init_or_resume)}}


def _extra(rank, world, mesh, payload):
    out = {}
    # what must raise: a mesh of another size, arenas that do not split
    out["raises"] = {
        "make_mesh": _raises(lambda: meshmod.make_mesh(world + 1)),
        "make_host_mesh": _raises(lambda: meshmod.make_host_mesh(
            2, world)),
    }
    odd = Trainer(RocketLeagueEnv(EnvConfig(num_envs=world + 1,
                                            device="cpu")),
                  PPOConfig(policy_layers=(8,), critic_layers=(8,),
                            shared_head_layers=()))
    out["raises"]["shard_train_state"] = _raises(
        lambda: meshmod.shard_train_state(odd, odd.init(0), mesh))

    # a weighted iteration against an old version, two minibatches
    trainer = sharding_trainer(batch_size=payload["weighted_batch"])
    state = meshmod.shard_train_state(trainer, trainer.init(0), mesh)
    state, metrics = weighted_iteration(trainer, state)
    out["weighted_params"] = params_np(trainer.learner)
    out["weighted_metrics"] = metrics_np(metrics)

    # the Welford merge over the ranks: each rank holds its block of rows
    shard = trainer.env.shard
    out["welford"] = {}
    for name, (x, start) in payload["welford"].items():
        st = welford.WelfordState(*(torch.tensor(v) for v in start))
        per = x.shape[0] // world
        got = welford.update_batch(
            st, torch.from_numpy(x[rank * per:(rank + 1) * per]),
            shard.all_sum)
        out["welford"][name] = [g.numpy().copy()
                                for g in (got.count, got.mean, got.m2)]

    # the learning half with the JAX package's parameters, trajectory and
    # permutations, on this rank's arena
    lp = payload["learn"]
    trainer = learn_trainer()
    trainer.learner.params_from_jax(lp["params"])
    state = meshmod.shard_train_state(trainer, trainer.init(0), mesh)
    state.return_stat = welford.WelfordState(
        *(torch.tensor(v) for v in lp["return_stat"]))
    sh = trainer.env.shard
    block = slice(sh.offset, sh.offset + sh.local_envs)
    traj = {k: (torch.from_numpy(np.ascontiguousarray(v[:, block]))
                if k != "reward_components" else
                {n: torch.from_numpy(c) for n, c in v.items()})
            for k, v in lp["traj"].items()}
    state, metrics = trainer.learn(state, traj,
                                   perms=torch.from_numpy(lp["perms"]))
    out["learn_metrics"] = metrics_np(metrics)
    out["learn_params"] = trainer.learner.params_to_jax()
    out["learn_return_stat"] = [v.numpy().copy() for v in (
        state.return_stat.count, state.return_stat.mean,
        state.return_stat.m2)]
    out["learn_counters"] = (state.total_timesteps, state.iterations)
    return out



# ---------------------------------------------------------------------------
# spawning

def _rank_main(rank, world, store, folder, payload):
    torch.set_num_threads(1)
    try:
        meshmod.initialize_distributed(f"file://{store}", world, rank,
                                       device="cpu")
        result = iterate_job(rank, world, payload)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(folder, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(result, os.path.join(folder, f"rank{rank}.pt"))


def start(world: int, folder, payload: dict) -> tuple:
    """Start ``world`` gloo ranks of ``iterate_job``; ``finish`` waits for
    them."""
    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(folder, "store"),
                               folder, payload))
             for r in range(world)]
    for p in procs:
        p.start()
    return folder, procs, time.monotonic()


def finish(started: tuple, timeout: float = 180.0) -> list:
    """Each rank's result of a job from ``start``.  Raises if a rank
    failed, or kills every rank and raises if the job outlasts
    ``timeout`` seconds from its start."""
    folder, procs, t0 = started
    world = len(procs)
    for p in procs:
        p.join(max(t0 + timeout - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(folder, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung:
        raise RuntimeError(f"{world} ranks: ranks {hung} still ran "
                           f"after {timeout} s and were killed\n"
                           + "\n".join(errors))
    codes = [p.exitcode for p in procs]
    if any(codes) or errors:
        raise RuntimeError(f"{world} ranks failed, exit codes "
                           f"{codes}\n" + "\n".join(errors))
    return [torch.load(os.path.join(folder, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def unsharded(batch_size: int = 4096, weighted: bool = False) -> dict:
    """The unsharded port on the same configuration: the initial state and
    parameters, and those after one iteration."""
    trainer = sharding_trainer(batch_size)
    state = trainer.init(0)
    out = {"state0": state_np(state), "params0": params_np(trainer.learner)}
    state, metrics = (weighted_iteration(trainer, state) if weighted
                      else trainer.train_iteration(state))
    out.update(params=params_np(trainer.learner), metrics=metrics_np(metrics),
               state=state_np(state),
               counters=(state.total_timesteps, state.iterations),
               return_stat=[float(x) for x in (state.return_stat.count,
                                               state.return_stat.mean,
                                               state.return_stat.m2)])
    return out
