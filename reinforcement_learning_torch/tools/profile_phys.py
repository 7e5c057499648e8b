"""Physics-step throughput probe over the port's backends (the twin of the
JAX package's ``tools/profile_phys.py``).

Not a test -- a perf triage tool.  Run on the card:
    python -m reinforcement_learning_torch.tools.profile_phys [num_envs]
        [backends...] [--device=cpu]
backends default: portable planes kernel.  The JAX labels map so:
``mesh`` -> ``portable`` (the portable engine on the mesh, dynamic wheel
rays), ``planes`` (the portable engine on the analytic planes),
``pallas`` -> ``kernel`` (the kernel on the plane arena), ``pallas_mesh``
-> ``kernel_mesh`` (the kernel at full fidelity).  The "first call"
column includes the kernel's nvcc build where it is not built yet.
"""
from __future__ import annotations

import sys
import time

ITERS = 50
BACKENDS = {   # label -> (physics_backend, use_mesh, dynamic_wheel_rays)
    "portable": ("portable", True, True),
    "planes": ("portable", False, False),
    "kernel": ("kernel", False, False),
    "kernel_mesh": ("kernel", True, True),
}


def probe(label, N: int = 256, device=None, **arena_kw) -> dict:
    """``ITERS`` env steps of ``N`` x 2v2 with action 0 on one backend,
    after a first call; prints one line and returns its numbers."""
    import dataclasses

    import torch

    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.physics import step as stepmod
    cfg = EnvConfig(num_envs=N, team_size=2, device=device,
                    physics_backend=arena_kw.pop("backend", "portable"))
    cfg = dataclasses.replace(
        cfg, arena=stepmod.ArenaParams(num_cars=cfg.cars_per_arena,
                                       **arena_kw))
    env = RocketLeagueEnv(cfg)
    dev = env.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    states, obs, mask = env.reset(0)
    act = torch.zeros((N, cfg.cars_per_arena), dtype=torch.int64,
                      device=dev)
    t0 = time.perf_counter()
    states, out = env.step(states, act)
    sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ITERS):
        states, out = env.step(states, act)
    sync()
    dt = time.perf_counter() - t0
    sps = N * ITERS / dt
    print(f"{label:11s} first call {first_s:7.1f}s  "
          f"{dt / ITERS * 1e3:8.2f} ms/step  {sps:12,.0f} env-steps/s "
          f"({sps * cfg.cars_per_arena:12,.0f} player-steps/s)", flush=True)
    return {"first_s": first_s, "ms_per_step": dt / ITERS * 1e3,
            "env_steps_per_s": sps,
            "player_steps_per_s": sps * cfg.cars_per_arena}


def main(N: int = 256, which=("portable", "planes", "kernel"),
         device=None) -> dict:
    """Probes the backends in ``which`` (labels of ``BACKENDS``)."""
    import torch

    from reinforcement_learning_torch.device import resolve_device
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={dev} ({name}) num_envs={N}")
    out = {}
    for label in which:
        backend, mesh, rays = BACKENDS[label]
        out[label] = probe(label, N, dev, use_mesh=mesh,
                           dynamic_wheel_rays=rays, backend=backend)
    return out


if __name__ == "__main__":
    from reinforcement_learning_torch.tools.parity_battery import option
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 256,
         args[1:] or ("portable", "planes", "kernel"),
         device=option("device"))
