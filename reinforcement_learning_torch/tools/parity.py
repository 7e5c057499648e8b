"""Parity harness: the reference RocketSim (the compiled oracle binary) vs
the port's two physics routes, tick for tick (the twin of the JAX
package's ``tools/parity.py``).

The oracle (``tools/oracle/``) compiles the reference engine as a
black-box golden-trace generator (BASELINE config #1: seeded trajectory
replay).  Scenarios are described as (initial state, per-tick controls);
the oracle and the port step them and the traces are compared with
BallState::Matches-style margins (reference: Ball.h:38 -- pos 0.8uu, vel
0.4, angvel 0.02).

The binary is the committed ``tools/oracle/build-fma/rs_oracle`` unless
the caller names another (``oracle_bin``, the tools' ``--oracle=PATH``):
the repository holds no other build, and ``tools/oracle/build.sh`` needs
the reference's sources to make one.  A missing binary raises
``FileNotFoundError`` naming it.

The port's routes:

* ``run_torch``: the portable engine (``physics/step.py`` ``arena_tick``,
  the JAX package's XLA engine), the grid mesh and dynamic wheel rays;
* ``run_torch_kernel``: the arena-step kernel (``ops/arena_step.py``, the
  JAX package's Pallas megakernel) at ``tick_skip=1, action_delay=0``, the
  facet arena and dynamic wheel rays; on the CPU its plain version.

Both batch the scenarios of one (cars, teams, ticks) signature into one
arena axis and run on the card unless ``device`` says otherwise.
Without meshes the reference soccar world is its 4 implicit planes
(floor z=0, ceiling, side walls; Arena.cpp:1060-1100).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

MAGIC = 0x4F52534A
ROOT = Path(__file__).resolve().parents[2]
# The FMA build (-march=native -ffp-contract=fast), the one in the
# repository; the plain -O2 build is what the chaos control compares it
# with, and exists only where tools/oracle/build.sh ran.
ORACLE_BIN_FMA = str(ROOT / "tools" / "oracle" / "build-fma" / "rs_oracle")
ORACLE_BIN_O2 = str(ROOT / "tools" / "oracle" / "build" / "rs_oracle")
ORACLE_BIN = ORACLE_BIN_FMA
CMF_DIR = ROOT / "build" / "torch_oracle" / "cmf"

CAR_OUT_FIELDS = [
    "pos", "fwd", "right", "up", "vel", "ang_vel",      # 6x3
    "boost", "is_on_ground", "has_jumped", "has_double_jumped",
    "has_flipped", "is_jumping", "is_flipping", "jump_time", "flip_time",
    "air_time_since_jump", "is_supersonic", "handbrake_val", "is_demoed",
]
CAR_OUT_FLOATS = 6 * 3 + 13


@dataclasses.dataclass
class CarInit:
    team: int = 0
    pos: tuple = (0.0, 0.0, 17.01)
    fwd: tuple = (1.0, 0.0, 0.0)
    right: tuple = (0.0, 1.0, 0.0)
    up: tuple = (0.0, 0.0, 1.0)
    vel: tuple = (0.0, 0.0, 0.0)
    ang_vel: tuple = (0.0, 0.0, 0.0)
    boost: float = 33.3
    is_on_ground: bool = True
    has_jumped: bool = False
    has_double_jumped: bool = False
    has_flipped: bool = False
    flip_rel_torque: tuple = (0.0, 0.0, 0.0)
    jump_time: float = 0.0
    flip_time: float = 0.0
    is_flipping: bool = False
    is_jumping: bool = False
    air_time_since_jump: float = 0.0
    time_spent_boosting: float = 0.0
    supersonic_time: float = 0.0
    handbrake_val: float = 0.0


@dataclasses.dataclass
class Scenario:
    """controls: (n_ticks, n_cars, 8) float array, columns
    throttle steer pitch yaw roll jump boost handbrake."""
    cars: list
    controls: np.ndarray
    ball_pos: tuple = (0.0, 0.0, 93.15)
    ball_vel: tuple = (0.0, 0.0, 0.0)
    ball_ang_vel: tuple = (0.0, 0.0, 0.0)
    game_mode: int = 0

    @property
    def n_cars(self):
        return len(self.cars)

    @property
    def n_ticks(self):
        return self.controls.shape[0]


def _pack_scenarios(scenarios) -> bytes:
    out = [struct.pack("<ii", MAGIC, len(scenarios))]
    for sc in scenarios:
        out.append(struct.pack("<iii", sc.n_cars, sc.n_ticks, sc.game_mode))
        out.append(np.asarray(
            [*sc.ball_pos, *sc.ball_vel, *sc.ball_ang_vel],
            "<f4").tobytes())
        for car in sc.cars:
            out.append(struct.pack("<i", car.team))
            vals = [*car.pos, *car.fwd, *car.right, *car.up, *car.vel,
                    *car.ang_vel, car.boost,
                    float(car.is_on_ground), float(car.has_jumped),
                    float(car.has_double_jumped), float(car.has_flipped),
                    *car.flip_rel_torque, car.jump_time, car.flip_time,
                    float(car.is_flipping), float(car.is_jumping),
                    car.air_time_since_jump, car.time_spent_boosting,
                    car.supersonic_time, car.handbrake_val]
            out.append(np.asarray(vals, "<f4").tobytes())
        ctrl = np.ascontiguousarray(sc.controls, "<f4")
        assert ctrl.shape == (sc.n_ticks, sc.n_cars, 8)
        out.append(ctrl.tobytes())
    return b"".join(out)


def default_cmf_dir() -> str:
    """Writes the procedural soccar mesh as a .cmf the oracle can load
    (the reference refuses to create a soccar arena with no meshes);
    cached under build/torch_oracle/cmf/."""
    from reinforcement_learning_torch.physics import mesh as meshmod
    path = CMF_DIR / "soccar.cmf"
    verts, tris = meshmod.build_soccar_mesh()
    # The reference feeds .cmf coordinates straight into the bullet world
    # with NO unit conversion (CollisionMeshFile::MakeBulletMesh,
    # Arena::_AddStaticCollisionShape) -- real assets are stored in BT
    # units, so the oracle's copy must be too (1 bt = 50 uu).
    verts = verts / 50.0
    # regenerate when the procedural mesh changes (hash mismatch)
    if (not path.exists()
            or meshmod.cmf_hash(*meshmod.read_cmf(str(path)))
            != meshmod.cmf_hash(verts, tris)):
        CMF_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        meshmod.write_cmf(str(tmp), verts, tris)
        os.replace(tmp, path)
    return str(CMF_DIR)


def run_oracle(scenarios, workdir=None, cmf_dir=None, oracle_bin=None):
    """Returns a list of per-scenario dicts:
    {"ball": (T, 9), "cars": (T, C, CAR_OUT_FLOATS)}."""
    import tempfile
    oracle_bin = oracle_bin or ORACLE_BIN
    if not os.path.exists(oracle_bin):
        raise FileNotFoundError(
            f"{oracle_bin}: no oracle binary there (tools/oracle/build.sh "
            "builds one from the reference's sources)")
    if cmf_dir is None:
        cmf_dir = default_cmf_dir()
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        fin = os.path.join(td, "in.bin")
        fout = os.path.join(td, "out.bin")
        with open(fin, "wb") as f:
            f.write(_pack_scenarios(scenarios))
        cmd = [oracle_bin, fin, fout]
        if cmf_dir:
            cmd.append(cmf_dir)
        subprocess.run(cmd, check=True, timeout=600)
        raw = np.fromfile(fout, "<f4")
    results = []
    off = 0
    for sc in scenarios:
        per_tick = 9 + sc.n_cars * CAR_OUT_FLOATS
        block = raw[off:off + sc.n_ticks * per_tick]
        off += sc.n_ticks * per_tick
        block = block.reshape(sc.n_ticks, per_tick)
        results.append({
            "ball": block[:, :9],
            "cars": block[:, 9:].reshape(sc.n_ticks, sc.n_cars,
                                         CAR_OUT_FLOATS),
        })
    return results


def car_trace_field(cars: np.ndarray, name: str) -> np.ndarray:
    """Slice one named field out of a (T, C, CAR_OUT_FLOATS) car trace."""
    i = CAR_OUT_FIELDS.index(name)
    if i < 6:
        return cars[..., 3 * i:3 * i + 3]
    return cars[..., 18 + (i - 6)]


# ---------------------------------------------------------------------------
# the port's side


def _scenario_phys(sc: Scenario, params, device=None):
    """Initial PhysicsState for one scenario (no arena axis)."""
    import torch

    from reinforcement_learning_torch.physics import step as stepmod

    phys = stepmod.make_physics_state(params, device=device)
    arena = phys.arena
    dev = arena.cars.pos.device
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32),  # noqa: E731
                                  device=dev)
    b = lambda v: torch.as_tensor(np.asarray(v, bool),  # noqa: E731
                                  device=dev)
    rot = np.stack([np.stack([c.fwd, c.right, c.up], axis=-1)
                    for c in sc.cars])       # columns fwd/right/up
    cars = dataclasses.replace(
        arena.cars,
        pos=f([c.pos for c in sc.cars]),
        rot=f(rot),
        vel=f([c.vel for c in sc.cars]),
        ang_vel=f([c.ang_vel for c in sc.cars]),
        boost=f([c.boost for c in sc.cars]),
        is_on_ground=b([c.is_on_ground for c in sc.cars]),
        has_jumped=b([c.has_jumped for c in sc.cars]),
        has_double_jumped=b([c.has_double_jumped for c in sc.cars]),
        has_flipped=b([c.has_flipped for c in sc.cars]),
        flip_rel_torque=f([c.flip_rel_torque for c in sc.cars]),
        jump_time=f([c.jump_time for c in sc.cars]),
        flip_time=f([c.flip_time for c in sc.cars]),
        is_flipping=b([c.is_flipping for c in sc.cars]),
        is_jumping=b([c.is_jumping for c in sc.cars]),
        air_time_since_jump=f([c.air_time_since_jump for c in sc.cars]),
        time_spent_boosting=f([c.time_spent_boosting for c in sc.cars]),
        supersonic_time=f([c.supersonic_time for c in sc.cars]),
        handbrake_val=f([c.handbrake_val for c in sc.cars]),
    )
    ball = dataclasses.replace(arena.ball, pos=f(sc.ball_pos),
                               vel=f(sc.ball_vel),
                               ang_vel=f(sc.ball_ang_vel))
    return dataclasses.replace(phys, arena=dataclasses.replace(
        arena, cars=cars, ball=ball))


def _trace_rows(arena):
    """(ball_row (..., 9), car_rows (..., C, CAR_OUT_FLOATS)) float32
    tensors from an arena, with or without an arena axis."""
    import torch
    b, c = arena.ball, arena.cars
    ball_row = torch.cat([b.pos, b.vel, b.ang_vel], -1)
    col = lambda x: x.to(torch.float32)[..., None]  # noqa: E731
    flat = torch.cat([
        c.pos, c.rot[..., 0], c.rot[..., 1], c.rot[..., 2],
        c.vel, c.ang_vel,
        col(c.boost), col(c.is_on_ground),
        col(c.has_jumped), col(c.has_double_jumped),
        col(c.has_flipped), col(c.is_jumping),
        col(c.is_flipping), col(c.jump_time),
        col(c.flip_time), col(c.air_time_since_jump),
        col(c.is_supersonic), col(c.handbrake_val),
        col(c.is_demoed)], -1)
    return ball_row, flat


def _groups(scenarios) -> dict:
    """(n_cars, teams, n_ticks) -> indices of the scenarios with it."""
    groups = {}
    for idx, sc in enumerate(scenarios):
        sig = (sc.n_cars, tuple(c.team for c in sc.cars), sc.n_ticks)
        groups.setdefault(sig, []).append(idx)
    return groups


def _run_batched(scenarios, params_of, tick, device):
    """Step every signature group of ``scenarios`` as one arena axis with
    ``tick(phys, controls (E, C, 8), respawn (E, C), params, teams)``;
    traces in run_oracle layout, kept on the device until the end."""
    import torch

    from reinforcement_learning_torch.device import resolve_device, tree_map

    dev = resolve_device(device)
    results = [None] * len(scenarios)
    for (n_cars, teams, n_ticks), idxs in _groups(scenarios).items():
        params = params_of(n_cars)
        phys = tree_map(lambda *xs: torch.stack(xs),
                        *[_scenario_phys(scenarios[i], params, dev)
                          for i in idxs])
        E = len(idxs)
        respawn = torch.zeros((E, n_cars), dtype=torch.int32, device=dev)
        controls = torch.as_tensor(np.stack(
            [np.asarray(scenarios[i].controls, np.float32) for i in idxs],
            axis=1), device=dev)                       # (T, E, C, 8)
        balls, cars = [], []
        for t in range(n_ticks):
            phys = tick(phys, controls[t], respawn, params, teams)
            b, c = _trace_rows(phys.arena)
            balls.append(b)
            cars.append(c)
        ball = torch.stack(balls, 1).cpu().numpy()      # (E, T, 9)
        car = torch.stack(cars, 1).cpu().numpy()        # (E, T, C, 31)
        for e, i in enumerate(idxs):
            results[i] = {"ball": ball[e], "cars": car[e]}
    return results


def run_torch_kernel(scenarios, device=None):
    """Steps the port's kernel route (``ops.arena_step``: the CUDA kernel on
    the card, its plain version ``ops.ctick`` on the CPU; the facet arena
    and dynamic wheel rays, the default training path) over the
    scenarios, returning traces in run_oracle layout.  Scenarios are
    batched into one arena axis per (n_cars, teams, n_ticks) signature.
    Respawn draws are a fixed row 0, as the JAX tool's zeros."""
    from reinforcement_learning_torch.ops import arena_step as A
    from reinforcement_learning_torch.physics import step as stepmod

    def params_of(n_cars):
        return stepmod.ArenaParams(num_cars=n_cars, use_mesh=True,
                                   dynamic_wheel_rays=True)

    def tick(phys, controls, respawn, params, teams):
        return A.arena_step(phys, controls, respawn, params, teams,
                            tick_skip=1, action_delay=0)
    return _run_batched(scenarios, params_of, tick, device)


def run_torch(scenarios, device=None):
    """Steps the port's portable engine (``physics.step.arena_tick``, the
    JAX package's XLA engine) over the scenarios, returning traces in the
    same layout as run_oracle.  Scenarios are batched into one arena axis
    per (n_cars, teams, n_ticks) signature (every arena is stepped by the
    same ops, independently of the others).  A demolished car respawns at
    row 0 of the respawn table (the JAX tick draws it from a fixed
    ``PRNGKey(0)``; no car respawns within the battery's 240 ticks)."""
    from reinforcement_learning_torch.physics import step as stepmod

    def params_of(n_cars):
        # RLT_NO_MESH=1: collide against the analytic planes instead of the
        # mesh (isolates mesh-induced divergence in debugging)
        return stepmod.ArenaParams(
            num_cars=n_cars, use_mesh=not os.environ.get("RLT_NO_MESH"))

    # oracle control order: thr steer pitch yaw roll jump boost handbrake;
    # engine control vector order (envs/actions.py): thr steer pitch yaw
    # roll jump boost handbrake -- identical.
    def tick(phys, controls, respawn, params, teams):
        cars = dataclasses.replace(phys.arena.cars, controls=controls)
        phys = dataclasses.replace(phys, arena=dataclasses.replace(
            phys.arena, cars=cars))
        return stepmod.arena_tick(phys, teams, respawn, params)
    return _run_batched(scenarios, params_of, tick, device)
