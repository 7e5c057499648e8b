"""The physics step kernel: build, bind and launch ``csrc/arena_step.cu``.

``arena_step`` advances a batch of arenas by one env step (``tick_skip``
physics ticks, new controls from tick ``action_delay``).  It is the twin of
the TPU megakernel ``pallas_arena_step`` (reinforcement_learning_tpu/ops/
pallas_step.py).  On CUDA tensors it launches the kernel, built at first
use by nvcc into ``build/torch_kernels/`` and bound with ctypes; on CPU
tensors it runs the plain PyTorch version, ``ops.ctick``.  Nothing falls
back: a CUDA tensor either reaches the kernel or raises.

On the card the wrapper (pack, launch, unpack) is replayed from one CUDA
graph per ``params``, ``teams``, ``tick_skip``, ``action_delay`` and the
inputs' shapes (``utils/cuda_graph.py``, counters ``kernel.eager``,
``kernel.graph_captures``, ``kernel.graph_replays``): the first call runs
eagerly, the second captures, the later ones copy the inputs in, replay
and hand back fresh outputs.

The kernel reads struct-of-arrays buffers with the env axis innermost:
``f32 (72*C + 21 + 34, E)``, ``i32 (3*C + 1 + 34, E)``, ``u8 (19*C + 1 + 34,
E)``; ``_pack`` and ``_unpack`` convert a batched ``PhysicsState`` to and
from them in the order the kernel's ``load`` and ``store`` expect.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch.ops import ctick
from reinforcement_learning_torch.ops.pack import (CAR_BOOLS, CAR_INTS,
                                                   CAR_SCALARS_F32, CAR_VECS,
                                                   LATCHES)
from reinforcement_learning_torch.physics import arena_geom as geom
from reinforcement_learning_torch.physics import facet_arena
from reinforcement_learning_torch.physics.car import WheelControlsState
from reinforcement_learning_torch.physics.state import (ArenaState, BallState,
                                                        CarsState, PadsState)
from reinforcement_learning_torch.physics.step import PhysicsState
from reinforcement_learning_torch.utils import cuda_graph, tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "arena_step.cu", CSRC / "cvec.cuh", CSRC / "facets.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -fmad=false: no a*b+c is contracted into an FMA, so every operation rounds
# as the plain version's elementwise tensor ops do.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC")
SUPPORTED_CARS = (1, 2, 4, 6)   # the kernel's instantiations
# one object per car count plus the dispatcher, compiled in parallel
_OBJECTS = tuple((f"nc{n}", f"-DARENA_STEP_NC={n}") for n in SUPPORTED_CARS
                 ) + (("dispatch", "-DARENA_STEP_DISPATCH"),)
MAX_CARS = 8

_CURVES = (  # the kernel's CV_* order
    C.DRIVE_SPEED_TORQUE_FACTOR_CURVE, C.STEER_ANGLE_FROM_SPEED_CURVE,
    C.POWERSLIDE_STEER_ANGLE_FROM_SPEED_CURVE,
    C.NON_STICKY_FRICTION_FACTOR_CURVE, C.LAT_FRICTION_CURVE,
    C.LONG_FRICTION_CURVE, C.HANDBRAKE_LAT_FRICTION_FACTOR_CURVE,
    C.HANDBRAKE_LONG_FRICTION_FACTOR_CURVE,
    C.BALL_CAR_EXTRA_IMPULSE_FACTOR_CURVE, C.BUMP_VEL_AMOUNT_GROUND_CURVE,
    C.BUMP_VEL_AMOUNT_AIR_CURVE, C.BUMP_UPWARD_VEL_AMOUNT_CURVE)
_DEMO_MODES = {"NORMAL": 0.0, "ON_CONTACT": 1.0, "DISABLED": 2.0}


# ---------------------------------------------------------------------------
# Build and bind

def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """The path of nvcc; raises where there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the arena_step kernel is built "
                           "on a machine with the CUDA toolkit")
    return path


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernel for sm_90a unless a build of these exact sources
    exists: one nvcc per car count and one for the dispatcher, all started
    together, then a link.  Returns (path of the .so, nvcc's output).
    ``verbose`` adds ``-Xptxas -v`` (registers, spills) and always
    rebuilds."""
    out = BUILD_DIR / f"arena_step_{_source_hash()}.so"
    if out.exists() and not verbose:
        return out, ""
    nvcc_path = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for tag, define in _OBJECTS:
            obj = os.path.join(tmpdir, f"{tag}.o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc_path, *NVCC_FLAGS,
                 *(("-Xptxas", "-v") if verbose else ()),
                 define, "-c", "-o", obj, str(SOURCES[0])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        so = os.path.join(tmpdir, "arena_step.so")
        link = subprocess.run([nvcc_path, *ARCH, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(so, out)
    tracing.count("kernel.builds")
    return out, log + link.stdout + link.stderr


@functools.lru_cache(maxsize=None)
def _library(path: str | None = None):
    with tracing.span("setup.kernel"):
        lib = ctypes.CDLL(path or str(build()[0]))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.arena_step_launch.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i,
                                      i, p]
    lib.arena_step_launch.restype = i
    lib.arena_step_params_bytes.argtypes = []
    lib.arena_step_params_bytes.restype = i
    return lib


def launch_shape(lib, num_envs: int, num_cars: int) -> dict:
    """The kernel's launch for ``num_envs`` arenas: lanes per arena (a warp
    or a half-warp), arenas per block, threads per block, blocks, and the
    dynamic shared memory of a block."""
    for name in ("arena_step_lanes", "arena_step_arenas_per_block"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.arena_step_shared_bytes.argtypes = [ctypes.c_int]
    lib.arena_step_shared_bytes.restype = ctypes.c_int
    lanes = lib.arena_step_lanes()
    apb = lib.arena_step_arenas_per_block()
    return dict(lanes_per_arena=lanes, arenas_per_block=apb,
                threads_per_block=lanes * apb,
                blocks=-(-num_envs // apb),
                shared_bytes_per_block=lib.arena_step_shared_bytes(num_cars))


# ---------------------------------------------------------------------------
# Per-arena constants

@functools.lru_cache(maxsize=32)
def _consts(params, teams: tuple):
    return ctick.make_consts(params, np.asarray(teams))


@functools.lru_cache(maxsize=32)
def pack_params(params, teams: tuple) -> np.ndarray:
    """The kernel's ``Params`` struct as float32, field by field.  Values
    the plain version folds in double precision are folded here alike."""
    k = _consts(params, teams)
    mut = k.mut
    dt = k.dt
    he, off = np.asarray(k.half_extents), np.asarray(k.hitbox_offset)
    radius = mut.ball_radius
    travel = C.BTVehicle.MAX_SUSPENSION_TRAVEL
    sus_sub = C.BTVehicle.SUSPENSION_SUBTRACTION * C.BT_TO_UU
    f = []
    f += [float(t) for t in teams] + [0.0] * (MAX_CARS - len(teams))
    f += [dt]
    f += [mut.gravity_z, mut.jump_accel, mut.jump_immediate_force,
          mut.boost_accel_ground, mut.boost_accel_air,
          mut.boost_used_per_second, mut.respawn_delay,
          mut.bump_cooldown_time, mut.boost_pad_cooldown_big,
          mut.boost_pad_cooldown_small, mut.car_spawn_boost_amount,
          mut.ball_hit_extra_force_scale, mut.bump_force_scale, radius,
          mut.ball_max_speed, float(mut.unlimited_flips),
          float(mut.unlimited_double_jumps), _DEMO_MODES[mut.demo_mode],
          float(mut.enable_team_demos), mut.car_world_restitution,
          mut.car_world_friction]
    f += [1.0 / mut.car_mass, 1.0 / mut.ball_mass, mut.car_mass / 3.0,
          C.BT_TO_UU / mut.car_mass, (1.0 - mut.ball_drag) ** dt,
          (1.0 - C.FLIP_Z_DAMP_120) ** (dt * 120.0),
          C.CONTACT_BREAK_FRAC * (float(np.linalg.norm(he))
                                  + float(np.linalg.norm(off))),
          radius + C.CONTACT_BREAK_FRAC * float(np.linalg.norm(he)),
          C.CONTACT_BREAK_FRAC * (radius + C.SPHERE_BOUND_EXTRA),
          1.0 / (0.4 * mut.ball_mass * (radius * C.UU_TO_BT) ** 2),
          max(mut.ball_world_restitution, C.WORLD_RESTITUTION),
          min(mut.ball_world_friction, C.WORLD_FRICTION),
          mut.goal_base_threshold_y + radius, -radius * C.UU_TO_BT,
          C.SPLIT_IMPULSE_TURN_ERP * dt]
    f += list(k.half_extents) + list(k.hitbox_offset) + list(k.inv_i_local)
    f += list(k.he_eff_bt) + [v * 50.0 for v in k.he_eff_bt]
    f += [x for row in k.wheel_offsets for x in row]
    f += list(k.wheel_radii) + list(k.sus_rest) + list(k.sus_force_scale)
    f += [r + travel + rad - sus_sub
          for r, rad in zip(k.sus_rest, k.wheel_radii)]
    f += [r - travel for r in k.sus_rest] + [r + travel for r in k.sus_rest]
    f += [r + rad - sus_sub for r, rad in zip(k.sus_rest, k.wheel_radii)]
    f += [x for row in k.planes for x in row]
    f += [float(t) for t in geom._TRUE_PLANE]
    f += [x for row in k.corners_local for x in row]
    f += [x for row in k.pad_locs for x in row]
    f += [float(b) for b in k.pad_is_big]
    if len(k.respawn_table) != 4 or len(k.pad_locs) != 34:
        raise ValueError("the kernel is built for 4 respawn rows, 34 pads")
    f += [x for row in k.respawn_table for x in row]
    for xs, ys in _CURVES:
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        n = len(xs)
        if not 2 <= n <= 6:
            raise ValueError("the kernel's curves hold 2 to 6 points")
        pad = lambda v, m: list(v) + [0.0] * (m - len(v))  # noqa: E731
        f += [float(n)] + pad(xs, 6) + pad(ys, 6)
        f += pad(np.diff(xs), 5) + pad(np.diff(ys), 5)
    f += _pack_full_fidelity(k)
    f += _pack_game_mode(k)
    return np.asarray(f, np.float32)


def _pack_game_mode(k) -> list:
    """The game-mode tail of ``Params``: the mode's index in
    ``ctick.GAME_MODES`` and the snowday puck's values, folded in double
    precision as ``ctick._resolve_ball_world_snowday`` folds them (packed
    in every mode, so the struct keeps one size)."""
    return ([float(ctick.GAME_MODES.index(k.game_mode))]
            + list(ctick.puck_consts(k.mut, k.dt)))


# facet table rows in the kernel's order (facets.cuh BZ0.. and SNX..)
_BAND_ROWS = ("z0", "w0", "tw", "tz", "L", "nw", "nz", "lo_flat", "hi_flat",
              "cut_t0", "cut_ts")
_SIDE_ROWS = ("side_nx", "side_ny", "side_d", "side_ux", "side_uy", "lo0",
              "loS", "hi0", "hiS")


def _pack_full_fidelity(k) -> list:
    """The full-fidelity tail of ``Params``: the two flags, values folded in
    double precision, and the facet tables (packed in plane mode too, so
    the struct keeps one size)."""
    mut = k.mut
    he = k.half_extents
    hc = [v - C.MESH_COLLISION_MARGIN for v in he]
    t = k.facets or facet_arena.tables()
    bands = facet_arena.band_table(t)
    f = [float(k.use_mesh), float(k.dynamic_rays),
         C.SOLVER_ERP2 / k.dt, mut.ball_radius * mut.ball_radius,
         facet_arena.box_dist_margin(he)]
    f += hc
    f += [k.hitbox_offset[i] + sg[i] * hc[i]
          for sg in facet_arena.CORNER_SIGNS for i in range(3)]
    for name in _BAND_ROWS:
        f += [float(v) for v in bands[name]]
    for s in range(facet_arena.N_SIDES):
        f += [getattr(t, name)[s] for name in _SIDE_ROWS]
    return f


# ---------------------------------------------------------------------------
# State <-> kernel buffers

CAR_F, CAR_I, CAR_U, BALL_F, NPADS = 72, 3, 19, 21, 34


def _rows(per_car: torch.Tensor) -> torch.Tensor:
    """(E, C, k) -> (k*C, E): field-major rows, one car per row."""
    E = per_car.shape[0]
    return per_car.permute(2, 1, 0).reshape(-1, E)


def _pack(phys: PhysicsState):
    a, cars, wc = phys.arena, phys.arena.cars, phys.wheels
    E, Cn = cars.boost.shape
    f_car = torch.cat(
        [torch.stack([getattr(cars, n) for n in CAR_SCALARS_F32], -1)]
        + [getattr(cars, n) for n in CAR_VECS]
        + [cars.rot.reshape(E, Cn, 9), cars.last_controls, cars.controls,
           wc.steer_angle[..., None], wc.engine_force[..., None],
           wc.brake[..., None], wc.lat_friction, wc.long_friction], -1)
    b = a.ball
    f_ball = torch.cat([b.pos, b.vel, b.ang_vel, b.rot.reshape(E, 9),
                        torch.stack([b.hs_y_target_dir, b.hs_target_speed,
                                     b.hs_time_since_hit], -1)], -1)
    f = torch.cat([_rows(f_car), f_ball.T, a.pads.cooldown.T], 0)
    i = torch.cat([_rows(torch.stack([getattr(cars, n) for n in CAR_INTS],
                                     -1)),
                   a.tick_count[None], a.pads.prev_locked.T], 0)
    u_car = torch.cat(
        [torch.stack([getattr(cars, n) for n in CAR_BOOLS], -1),
         cars.wheels_with_contact,
         torch.stack([getattr(a, n) for n in LATCHES], -1)], -1)
    u = torch.cat([_rows(u_car), a.goal_scored[None], a.pads.is_active.T], 0)
    return (f.to(torch.float32).contiguous(), i.to(torch.int32).contiguous(),
            u.to(torch.uint8).contiguous())


def _unpack(f, i, u, E: int, Cn: int) -> PhysicsState:
    def cars_of(buf, k):
        return buf[:k * Cn].reshape(k, Cn, E).permute(2, 1, 0)  # (E, C, k)

    fc = cars_of(f, CAR_F)
    kw = {n: fc[..., j] for j, n in enumerate(CAR_SCALARS_F32)}
    for j, n in enumerate(CAR_VECS):
        kw[n] = fc[..., 12 + 3 * j:15 + 3 * j]
    kw["rot"] = fc[..., 36:45].reshape(E, Cn, 3, 3)
    kw["last_controls"] = fc[..., 45:53]
    kw["controls"] = fc[..., 53:61]
    ic = cars_of(i, CAR_I)
    kw.update({n: ic[..., j] for j, n in enumerate(CAR_INTS)})
    uc = cars_of(u, CAR_U).to(torch.bool)
    kw.update({n: uc[..., j] for j, n in enumerate(CAR_BOOLS)})
    kw["wheels_with_contact"] = uc[..., 11:15]
    kw = {n: t.contiguous() for n, t in kw.items()}
    g = f[CAR_F * Cn:CAR_F * Cn + BALL_F].T
    ball = BallState(pos=g[:, 0:3].contiguous(), vel=g[:, 3:6].contiguous(),
                     ang_vel=g[:, 6:9].contiguous(),
                     rot=g[:, 9:18].reshape(E, 3, 3).contiguous(),
                     hs_y_target_dir=g[:, 18].contiguous(),
                     hs_target_speed=g[:, 19].contiguous(),
                     hs_time_since_hit=g[:, 20].contiguous())
    ib = CAR_I * Cn
    ub = CAR_U * Cn
    pads = PadsState(
        is_active=u[ub + 1:ub + 1 + NPADS].T.to(torch.bool).contiguous(),
        cooldown=f[CAR_F * Cn + BALL_F:].T.contiguous(),
        prev_locked=i[ib + 1:ib + 1 + NPADS].T.contiguous())
    arena = ArenaState(
        cars=CarsState(**kw), ball=ball, pads=pads,
        tick_count=i[ib].contiguous(), goal_scored=u[ub].to(torch.bool),
        **{n: uc[..., 15 + j].contiguous() for j, n in enumerate(LATCHES)})
    wheels = WheelControlsState(
        steer_angle=fc[..., 61].contiguous(),
        engine_force=fc[..., 62].contiguous(),
        brake=fc[..., 63].contiguous(),
        lat_friction=fc[..., 64:68].contiguous(),
        long_friction=fc[..., 68:72].contiguous())
    return PhysicsState(arena=arena, wheels=wheels)


# ---------------------------------------------------------------------------
# The wrapper

def _launch(lib, phys, controls, respawn_idx, params, teams, tick_skip,
            action_delay, stream) -> PhysicsState:
    E, Cn = phys.arena.cars.boost.shape
    with tracing.span("kernel.pack"):
        f, i, u = _pack(phys)
        ctl = controls.permute(2, 1, 0).contiguous()          # (8, C, E)
        ridx = respawn_idx.transpose(0, 1).contiguous()       # (C, E)
        f_out, i_out, u_out = (torch.empty_like(f), torch.empty_like(i),
                               torch.empty_like(u))
        prm = pack_params(params, teams)
    if prm.nbytes != lib.arena_step_params_bytes():
        raise RuntimeError(
            f"Params layout mismatch: {prm.nbytes} bytes packed, kernel "
            f"expects {lib.arena_step_params_bytes()}")
    with tracing.span("kernel.launch"):
        err = lib.arena_step_launch(
            prm.ctypes.data, prm.nbytes, f.data_ptr(), i.data_ptr(),
            u.data_ptr(), f_out.data_ptr(), i_out.data_ptr(),
            u_out.data_ptr(), ctl.data_ptr(), ridx.data_ptr(), E, Cn,
            tick_skip, action_delay, stream)
    if err != 0:
        raise RuntimeError(f"arena_step kernel launch failed: error {err}")
    with tracing.span("kernel.unpack"):
        return _unpack(f_out, i_out, u_out, E, Cn)


def _launch_current(phys, controls, respawn_idx, *, params, teams,
                    tick_skip, action_delay) -> PhysicsState:
    """``_launch`` of the built kernel on the stream current at the call,
    which under a capture is the capture's own."""
    return _launch(_library(), phys, controls, respawn_idx, params, teams,
                   tick_skip, action_delay,
                   torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=32)
def _graphed(device: torch.device, params, teams: tuple, tick_skip: int,
             action_delay: int) -> cuda_graph.GraphedFn:
    """The wrapper of one key on ``device``, replayed per shape.  The
    captured launch holds ``Params``, packed from ``params`` and ``teams``,
    by value, and ``tick_skip`` and ``action_delay``: hence the key."""
    return cuda_graph.GraphedFn(
        functools.partial(_launch_current, params=params, teams=teams,
                          tick_skip=tick_skip, action_delay=action_delay),
        "kernel", device)


def arena_step(phys: PhysicsState, controls: torch.Tensor,
               respawn_idx: torch.Tensor, params, teams,
               tick_skip: int = 8, action_delay: int = 7) -> PhysicsState:
    """One env step of every arena.  ``phys``: batched state ``(E, C,
    ...)``; ``controls``: ``(E, C, 8)`` float32, applied from tick
    ``action_delay``; ``respawn_idx``: ``(E, C)`` int32, one respawn-table
    row per car for this step; ``params``: ``ArenaParams``; ``teams``: team
    id per car slot.  Runs soccar, heatseeker and snowday; raises
    ``NotImplementedError`` for hoops."""
    teams = tuple(int(t) for t in teams)
    ctick.check_supported(params)
    E, Cn = phys.arena.cars.boost.shape
    if controls.shape != (E, Cn, 8) or controls.dtype != torch.float32:
        raise ValueError(f"controls must be ({E}, {Cn}, 8) float32, got "
                         f"{tuple(controls.shape)} {controls.dtype}")
    if respawn_idx.shape != (E, Cn) or respawn_idx.dtype != torch.int32:
        raise ValueError(f"respawn_idx must be ({E}, {Cn}) int32, got "
                         f"{tuple(respawn_idx.shape)} {respawn_idx.dtype}")
    if len(teams) != Cn or Cn != params.num_cars:
        raise ValueError(f"{Cn} cars in the state, {len(teams)} teams, "
                         f"params.num_cars={params.num_cars}")
    dev = phys.arena.cars.pos.device
    if controls.device != dev or respawn_idx.device != dev:
        raise ValueError("state, controls and respawn_idx must share a "
                         "device")
    if dev.type == "cpu":
        return ctick.arena_step_reference(phys, controls, respawn_idx,
                                          _consts(params, teams), tick_skip,
                                          action_delay)
    if dev.type != "cuda":
        raise ValueError(f"arena_step runs on cuda or cpu, not {dev}")
    if Cn not in SUPPORTED_CARS:
        raise ValueError(f"the kernel is built for {SUPPORTED_CARS} cars")
    with torch.cuda.device(dev):
        out = _graphed(dev, params, teams, tick_skip, action_delay)(
            phys, controls, respawn_idx, key=None)
    tracing.count("kernel.launches")
    return out
