"""Data parallelism over the env axis on ``torch.distributed`` (the JAX
package's ``parallel/mesh.py``).

One process holds one device.  The arenas are split over the ranks in
contiguous blocks, everything else (the learner's parameters and optimiser
states, the Welford statistics, the counters, the generators) is
replicated.  The JAX package leaves the cross-env reductions to XLA's
GSPMD partitioner, which turns every batch mean of the iteration into a
``psum``; here each of them is an explicit all-reduce (``EnvShard.all_sum``,
``envs/shard.py``) in the trainer and the learner:

  * every draw is made at the global shape from the replicated generator,
    and a rank keeps its block, so a sharded run draws what the unsharded
    run draws;
  * a mean over rows is a local sum over the global count, all-reduced;
    the gradient of such a loss, all-reduced, is the unsharded gradient,
    so the ranks clip and step the same gradients and their parameters
    stay bit-equal without a broadcast inside the loop.

NCCL carries the collectives between cards, gloo on the CPU (and gloo on
CUDA tensors, staged through the host, where two ranks share one card).

    initialize_distributed()                # torchrun's variables
    mesh = make_mesh()                      # or make_host_mesh()
    state = trainer.init_or_resume()
    state = shard_train_state(trainer, state, mesh)
    state = trainer.train(state, iterations)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from reinforcement_learning_torch.device import resolve_device
from reinforcement_learning_torch.envs.shard import EnvShard

ENV_AXIS = "env"
HOST_AXIS = "host"

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *, device=None,
                           backend: str | None = None) -> bool:
    """Join the process group: ``torch.distributed.init_process_group``.

    Arguments default to the variables ``torchrun`` sets (``MASTER_ADDR``
    and ``MASTER_PORT`` for the address, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``).  ``coordinator_address`` is ``host:port`` or a URL
    (``tcp://...``, ``file://...``).  Returns False, doing nothing, when
    none of them is given or set: a single process runs unsharded.

    ``device``: the rank's device, ``"cuda"`` by default (card
    ``LOCAL_RANK``, made the current one), which raises without CUDA.
    ``backend``: NCCL for a CUDA device and gloo for the CPU unless given
    (gloo takes CUDA tensors too, through the host, which lets two ranks
    share one card where NCCL refuses)."""
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None
            and not any(v in env for v in _TORCHRUN_VARS)):
        return False
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator address: pass one or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=coordinator_address, world_size=world, rank=rank)
    return True


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"{name} is not set; pass it to "
                         "initialize_distributed")
    return int(os.environ[name])


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    return dist.get_world_size()


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """1-D ``("env",)`` mesh over every rank.  ``n_devices`` must equal
    the world size: one process holds one device.  ``device_type``:
    ``"cuda"`` under NCCL, else ``"cpu"``, unless given."""
    world = _world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} processes; the "
                         f"world has {world}")
    return init_device_mesh(_device_type(device_type), (n,),
                            mesh_dim_names=(ENV_AXIS,))


def make_host_mesh(n_hosts: int | None = None,
                   devices_per_host: int | None = None,
                   device_type: str | None = None) -> DeviceMesh:
    """2-D ``("host", "env")`` mesh: rows are hosts, columns the ranks of a
    host, in rank order.  ``devices_per_host`` defaults to torchrun's
    ``LOCAL_WORLD_SIZE`` (or the world over ``n_hosts``), ``n_hosts`` to
    the world over it; their product must equal the world size."""
    world = _world_size()
    if devices_per_host is None:
        devices_per_host = (world // n_hosts if n_hosts else
                            int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if n_hosts is None:
        n_hosts = world // max(devices_per_host, 1)
    if n_hosts * devices_per_host != world:
        raise ValueError(f"a {n_hosts} x {devices_per_host} mesh needs "
                         f"{n_hosts * devices_per_host} processes; the "
                         f"world has {world}")
    return init_device_mesh(_device_type(device_type),
                            (n_hosts, devices_per_host),
                            mesh_dim_names=(HOST_AXIS, ENV_AXIS))


def env_sharding(mesh: DeviceMesh) -> tuple:
    """The env axis (dim 0) sharded over every mesh axis: with DTensor's
    nesting, rank (h, e) of a (host, env) mesh holds block h * n_env + e,
    row-major."""
    return tuple(Shard(0) for _ in range(mesh.ndim))


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in range(mesh.ndim))


def _env_shard(mesh: DeviceMesh, global_envs: int) -> EnvShard:
    """Rank ``r`` (its flattened mesh index) of ``mesh`` holds arenas
    ``[r * E / W, (r + 1) * E / W)``.  Raises unless W divides E."""
    world = mesh.size()
    if global_envs % world:
        raise ValueError(f"{global_envs} arenas do not split over "
                         f"{world} ranks")
    coord = mesh.get_coordinate()
    rank = int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))
    if rank != dist.get_rank():
        raise ValueError(f"mesh index {rank} is not rank "
                         f"{dist.get_rank()}: a mesh lists ranks in order")
    local = global_envs // world
    groups = tuple(mesh.get_group(d) for d in reversed(range(mesh.ndim)))
    return EnvShard(global_envs, rank * local, local, groups, rank)


def _broadcast_(t: torch.Tensor):
    """Rank 0's ``t`` into ``t`` in place; a CPU tensor crosses NCCL
    through the current card."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        staged = t.cuda()
        dist.broadcast(staged, src=0)
        t.copy_(staged)
    else:
        dist.broadcast(t, src=0)


@torch.no_grad()
def shard_train_state(trainer, state, mesh: DeviceMesh):
    """Place a ``TrainState`` on ``mesh``: the env-batched parts
    (``env_states``, ``obs``, ``masks``) cut to this rank's block of
    arenas, everything else replicated from rank 0: the learner's
    parameters and optimiser states (kept in ``trainer.learner``), the
    Welford statistics, the counters and the generators.  The env (and
    through it the trainer) learns which block it holds.  Raises unless
    the world size divides the arenas, or if the trainer is sharded
    already."""
    env = trainer.env
    if env.shard.sharded:
        raise ValueError("the trainer is sharded already")
    shard = _env_shard(mesh, env.config.num_envs)

    learner = trainer.learner
    for t in learner.state_dict().values():
        _broadcast_(t)
    for opt in learner.optimizers.values():
        for st in (opt.state.values() if opt is not None else ()):
            for t in st.values():
                if isinstance(t, torch.Tensor):
                    _broadcast_(t)
    stats = [t for s in (state.return_stat, state.obs_stat)
             for t in (s.count, s.mean, s.m2)]
    for t in stats:
        _broadcast_(t)
    host = [trainer.generator_states, state.total_timesteps,
            state.iterations]
    dist.broadcast_object_list(
        host, src=0, device=(torch.device("cuda", torch.cuda.current_device())
                             if dist.get_backend() == "nccl" else None))
    trainer.generator_states = host[0]

    env.shard = shard
    return dataclasses.replace(state.map_envs(shard.take),
                               total_timesteps=host[1], iterations=host[2])


@torch.no_grad()
def gather_train_state(trainer, state):
    """The inverse of ``shard_train_state``: every rank's block of the
    env-batched parts gathered in rank order, so that the state is the
    whole one (on every rank; rank 0 writes checkpoints).  Unsharded,
    ``state`` as it is."""
    return state.map_envs(trainer.env.shard.gather)
