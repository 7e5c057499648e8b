"""The port's parity instruments (reinforcement_learning_torch/tools/parity,
parity_battery, parity_teacher, parity_debug, parity_kdebug) against the
JAX package's tools/ and the reference oracle (the committed
``tools/oracle/build-fma/rs_oracle``).

* The scenario battery, the oracle's input bytes and the soccar ``.cmf``
  are held equal to the JAX tools'; ``run_oracle`` through both on the
  same binary and mesh folder is bit-equal (3 scenarios x 60 ticks; the
  mesh folder is always passed, so nothing is written under
  ``tools/oracle/``).
* The port's traces are held against golden traces of the JAX tools made
  eagerly (``jax.disable_jit``; no JAX physics is jitted here):
  ``tools.parity.run_jax`` against ``run_torch`` (the portable engine),
  ``tools.parity_kdebug.run_ctick`` against ``run_torch_kernel`` (the
  kernel route, its plain version on the CPU), and
  ``tools.parity_teacher.run`` against the port's, both backends, the
  freerun traces 24 ticks long and the teacher-forced ticks of a window
  of 4 around each scenario's event (the start, the dodge, the hit at
  tick 22, the bump at tick 25), on drive_forward, front_flip,
  car_ball_hit, car_bump and ball_ramp_wall.  Tolerances are
  tests/test_torch_portable.py's: 1e-3 uu on lengths and velocities with
  1e-5 relative, 1e-5 (and 1e-5 relative) on unit vectors, angular
  velocities and times, flags exactly.  The file stores a hash of the JAX
  sources and of the oracle binary, and the tests fail once they change;
  regenerate it with

      python -m tests.test_torch_parity

  (one process per trace, in parallel).
* The batched ``run_torch`` is bit-equal to one scenario at a time, and
  ``parity_kdebug.run_ctick`` to the batched kernel route.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from reinforcement_learning_torch.tools import (parity, parity_battery,
                                                parity_debug, parity_kdebug,
                                                parity_teacher)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(DATA, "torch_parity_golden.npz")
T_TRACE = 24      # ticks of the freerun traces
T_TEACHER = 60    # the teacher's scenarios (the oracle traces' length)
SCENARIOS = ("drive_forward", "front_flip", "car_ball_hit", "car_bump",
             "ball_ramp_wall")
# teacher-forced ticks [t0, t1): the start (cold wheels), the dodge, the
# hit (tick 22), the bump (tick 25), the ball rolling on the mesh floor
WINDOWS = {"drive_forward": (1, 5), "front_flip": (14, 18),
           "car_ball_hit": (21, 25), "car_bump": (24, 28),
           "ball_ramp_wall": (1, 5)}
BACKENDS = ("xla", "ctick")
# the JAX sources the golden traces come from, relative to the repo root
REFERENCE_SOURCES = tuple(
    f"reinforcement_learning_tpu/{p}" for p in (
        "constants.py", "maths.py", "ops/ctick.py", "ops/cvec.py",
        "ops/pack.py", "physics/arena_geom.py", "physics/box_box.py",
        "physics/box_tri.py", "physics/car.py", "physics/contacts.py",
        "physics/facet_arena.py", "physics/formulas.py", "physics/mesh.py",
        "physics/state.py", "physics/step.py", "physics/world.py")) + (
    "tools/parity.py", "tools/parity_battery.py", "tools/parity_kdebug.py",
    "tools/parity_teacher.py")

ATOL_LEN = 1e-3    # uu, uu/s: arena-scale lengths and velocities
RTOL = 1e-5
ATOL_UNIT = 1e-5   # unit vectors, angles, body-scale quantities

# the car row's columns (parity.CAR_OUT_FIELDS) by tolerance class
_LEN = list(range(0, 3)) + list(range(12, 15)) + [18]     # pos, vel, boost
_UNIT = list(range(3, 12)) + list(range(15, 18)) + [25, 26, 27, 29]
_FLAG = [19, 20, 21, 22, 23, 24, 28, 30]


def reference_hash() -> str:
    h = hashlib.sha256()
    for rel in REFERENCE_SOURCES:
        h.update(rel.encode())
        with open(os.path.join(ROOT, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def oracle_hash() -> str:
    with open(parity.ORACLE_BIN_FMA, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def assert_rows_close(got: dict, want: dict, what: str):
    """Traces in run_oracle layout, ``got`` the port's, ``want`` JAX's."""
    assert got["cars"].shape == want["cars"].shape, what
    assert got["ball"].shape == want["ball"].shape, what
    gc, wc = got["cars"], want["cars"]

    def close(a, b, atol, cols, label):
        a, b = a[..., cols], b[..., cols]
        bad = np.abs(a - b) > atol + RTOL * np.abs(b)
        assert not bad.any(), (
            f"{what}: {label} off by {np.abs(a - b).max():.3g} at "
            f"{np.argwhere(bad)[0].tolist()}")
    close(gc, wc, ATOL_LEN, _LEN, "car lengths/velocities/boost")
    close(gc, wc, ATOL_UNIT, _UNIT, "car unit vectors/angular/times")
    assert np.array_equal(gc[..., _FLAG], wc[..., _FLAG]), f"{what}: flags"
    close(got["ball"], want["ball"], ATOL_LEN, list(range(6)),
          "ball pos/vel")
    close(got["ball"], want["ball"], ATOL_UNIT, [6, 7, 8], "ball ang_vel")


# ---------------------------------------------------------------------------
# golden traces (JAX side; only ``python -m tests.test_torch_parity`` runs
# this part)

def _jax_job(job):
    """One golden trace of the JAX tools, eagerly."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tools import parity as jparity
    from tools import parity_battery as jbattery
    from tools import parity_kdebug as jkdebug
    from tools import parity_teacher as jteacher

    kind, name = job
    # the repository's oracle binary and a mesh folder outside tools/
    jparity.ORACLE_BIN = jparity.ORACLE_BIN_FMA
    jparity.default_cmf_dir = parity.default_cmf_dir
    sc = jbattery.scenarios(T_TRACE)[name]
    out = {}
    with jax.disable_jit():
        if kind == "run_jax":
            tr = jparity.run_jax(sc)
        elif kind == "run_ctick":
            tr = jkdebug.run_ctick(sc)
        else:
            backend = kind.split("_", 1)[1]
            if backend == "ctick":
                _keep_tick_consts()
            rows = []
            get = jax.device_get

            def recording(x):
                host = get(x)
                rows.append(jparity._trace_rows(host))
                return host
            jax.device_get = recording
            try:
                worst = jteacher.run(name, T_TEACHER, *WINDOWS[name],
                                     quiet=True, backend=backend)
            finally:
                jax.device_get = get
            tr = {"ball": np.stack([r[0] for r in rows]),
                  "cars": np.stack([r[1] for r in rows])}
            out[f"{kind}/{name}/worst"] = np.array(
                [worst[k] for k in sorted(worst)], np.float64)
    out[f"{kind}/{name}/ball"] = np.asarray(tr["ball"], np.float32)
    out[f"{kind}/{name}/cars"] = np.asarray(tr["cars"], np.float32)
    print(kind, name, "done", flush=True)
    return out


def _keep_tick_consts():
    """The JAX teacher's loop rebinds the name its ctick tick closes over
    (``for k, v in errs.items()``, tools/parity_teacher.py:124): jitted,
    the tick keeps the ``TickConsts`` of its first trace; run eagerly it
    would read the string.  Hand ``ctick.step`` the consts it was first
    given, as the jitted tick does."""
    from reinforcement_learning_tpu.ops import ctick as jctick
    step, first = jctick.step, []

    def step_with_consts(k, *args, **kw):
        if isinstance(k, str):
            k = first[0]
        elif not first:
            first.append(k)
        return step(k, *args, **kw)
    jctick.step = step_with_consts


def regenerate(workers: int = 6):
    import concurrent.futures
    import multiprocessing
    jobs = [(k, n) for k in ("run_jax", "run_ctick", "teacher_xla",
                             "teacher_ctick") for n in SCENARIOS]
    data = {"reference_sha256": np.array(reference_hash()),
            "oracle_sha256": np.array(oracle_hash())}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=ctx) as pool:
        for part in pool.map(_jax_job, jobs):
            data.update(part)
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(GOLDEN, **data)
    print("wrote", GOLDEN)


@functools.lru_cache(maxsize=None)
def load_golden() -> dict:
    data = np.load(GOLDEN)
    assert str(data["reference_sha256"]) == reference_hash(), (
        "the JAX sources changed since the golden traces were made: "
        "regenerate them with python -m tests.test_torch_parity")
    assert str(data["oracle_sha256"]) == oracle_hash(), (
        "the oracle binary changed since the golden traces were made")
    return {k: data[k] for k in data.files}


def golden(kind, name) -> dict:
    g = load_golden()
    return {"ball": g[f"{kind}/{name}/ball"], "cars": g[f"{kind}/{name}/cars"]}


# ---------------------------------------------------------------------------
# the port's runs, shared by the tests

# the oracle-equality test's scenarios; their 60-tick traces feed the
# teacher of the same scenarios
ORACLE_SCENARIOS = ("front_flip", "car_ball_hit", "car_bump")


@functools.lru_cache(maxsize=None)
def batched(route: str) -> tuple:
    run = parity.run_torch if route == "portable" else parity.run_torch_kernel
    scs = parity_battery.scenarios(T_TRACE)
    return tuple(run([scs[n] for n in SCENARIOS], device="cpu"))


@functools.lru_cache(maxsize=None)
def oracle_run(names: tuple) -> dict:
    """The port's ``run_oracle`` over ``names`` at T_TEACHER ticks, in one
    call."""
    scs = parity_battery.scenarios(T_TEACHER)
    refs = parity.run_oracle([scs[n] for n in names],
                             cmf_dir=parity.default_cmf_dir())
    return dict(zip(names, refs))


def oracle_trace(name: str) -> dict:
    names = (ORACLE_SCENARIOS if name in ORACLE_SCENARIOS
             else tuple(n for n in SCENARIOS if n not in ORACLE_SCENARIOS))
    return oracle_run(names)[name]


# ---------------------------------------------------------------------------
# the JAX tools' inputs, bytes and mesh

def _jax_scenarios(T):
    from tools import parity_battery as jbattery
    return jbattery.scenarios(T)


@pytest.mark.parametrize("T", [T_TRACE, 240])
def test_scenarios_match_jax(T):
    ours, theirs = parity_battery.scenarios(T), _jax_scenarios(T)
    assert list(ours) == list(theirs)
    assert len(ours) == 26
    for name in ours:
        a, b = ours[name], theirs[name]
        assert a.controls.dtype == b.controls.dtype == np.float32, name
        assert np.array_equal(a.controls, b.controls), name
        for f in ("ball_pos", "ball_vel", "ball_ang_vel", "game_mode"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert ([dataclasses.asdict(c) for c in a.cars]
                == [dataclasses.asdict(c) for c in b.cars]), name


@pytest.mark.parametrize("T", [T_TRACE, 240])
def test_pack_scenarios_matches_jax_bytes(T):
    from tools import parity as jparity
    ours, theirs = parity_battery.scenarios(T), _jax_scenarios(T)
    for name in ours:
        assert (parity._pack_scenarios([ours[name]])
                == jparity._pack_scenarios([theirs[name]])), name
    assert (parity._pack_scenarios(list(ours.values()))
            == jparity._pack_scenarios(list(theirs.values())))
    assert parity.MAGIC == jparity.MAGIC
    assert parity.CAR_OUT_FIELDS == jparity.CAR_OUT_FIELDS
    assert parity.CAR_OUT_FLOATS == jparity.CAR_OUT_FLOATS


def test_cmf_matches_jax_mesh():
    from reinforcement_learning_tpu.physics import mesh as jmesh
    from reinforcement_learning_torch.physics import mesh as tmesh
    d = parity.default_cmf_dir()
    assert os.path.realpath(d).startswith(
        os.path.realpath(os.path.join(ROOT, "build")))
    verts, tris = tmesh.read_cmf(os.path.join(d, "soccar.cmf"))
    jv, jt = jmesh.build_soccar_mesh()
    assert tmesh.cmf_hash(verts, tris) == jmesh.cmf_hash(jv / 50.0, jt)
    jv2, jt2 = jmesh.read_cmf(os.path.join(d, "soccar.cmf"))
    assert np.array_equal(jv2, (jv / 50.0).astype(np.float32))
    assert np.array_equal(jt2, jt)


def test_run_oracle_matches_jax():
    from tools import parity as jparity
    ours = oracle_run(ORACLE_SCENARIOS)
    theirs = jparity.run_oracle(
        [_jax_scenarios(T_TEACHER)[n] for n in ORACLE_SCENARIOS],
        cmf_dir=parity.default_cmf_dir(), oracle_bin=parity.ORACLE_BIN)
    for n, b in zip(ORACLE_SCENARIOS, theirs):
        for k in ("ball", "cars"):
            a = ours[n][k]
            assert a.dtype == b[k].dtype and np.array_equal(a, b[k]), (n, k)
    bump = ours["car_bump"]["cars"]
    assert bump.shape == (T_TEACHER, 2, parity.CAR_OUT_FLOATS)
    # the bump at tick 25 is in the trace
    vx = parity.car_trace_field(bump, "vel")[:, 0, 0]
    assert vx[24] == 1600.0 and vx[25] < 1000.0


def test_missing_oracle_binary_raises(tmp_path):
    sc = parity_battery.scenarios(T_TRACE)["drive_forward"]
    missing = str(tmp_path / "rs_oracle")
    with pytest.raises(FileNotFoundError, match=missing):
        parity.run_oracle([sc], cmf_dir="", oracle_bin=missing)


def test_the_default_oracle_is_the_committed_build():
    assert parity.ORACLE_BIN == parity.ORACLE_BIN_FMA
    assert parity.ORACLE_BIN_FMA == os.path.join(
        ROOT, "tools", "oracle", "build-fma", "rs_oracle")
    assert os.path.exists(parity.ORACLE_BIN)


# ---------------------------------------------------------------------------
# the port's routes against the JAX tools' golden traces

@pytest.mark.parametrize("name", SCENARIOS)
def test_run_torch_matches_jax_run_jax(name):
    got = batched("portable")[SCENARIOS.index(name)]
    assert_rows_close(got, golden("run_jax", name), f"run_torch {name}")


@pytest.mark.parametrize("name", SCENARIOS)
def test_run_torch_kernel_matches_jax_run_ctick(name):
    got = batched("kernel")[SCENARIOS.index(name)]
    assert_rows_close(got, golden("run_ctick", name),
                      f"run_torch_kernel {name}")


# the first ticks of a scenario alone against the same ticks of the batch
# (a scenario's first ticks do not depend on its length): the jump, and
# the ball rolling on the mesh floor
ALONE = 12    # the battery's scenarios take 12 ticks at least


def test_batched_run_torch_is_bit_equal_to_one_at_a_time():
    sc = parity_battery.scenarios(ALONE)["front_flip"]
    one = parity.run_torch([sc], device="cpu")[0]
    many = batched("portable")[SCENARIOS.index("front_flip")]
    for k in ("ball", "cars"):
        assert np.array_equal(one[k], many[k][:ALONE]), k


def test_run_ctick_is_bit_equal_to_the_batched_kernel_route():
    sc = parity_battery.scenarios(ALONE)["ball_ramp_wall"]
    one = parity_kdebug.run_ctick(sc, device="cpu")
    many = batched("kernel")[SCENARIOS.index("ball_ramp_wall")]
    for k in ("ball", "cars"):
        assert np.array_equal(one[k], many[k][:ALONE]), k


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_teacher_matches_jax(name, backend, monkeypatch):
    ref = oracle_trace(name)
    monkeypatch.setattr(parity, "run_oracle", lambda scs, **kw: [ref])
    rows = []
    trace_rows = parity._trace_rows

    def recording(arena):
        out = trace_rows(arena)
        rows.append(tuple(r[0].numpy() for r in out))
        return out
    monkeypatch.setattr(parity, "_trace_rows", recording)
    worst = parity_teacher.run(name, T_TEACHER, *WINDOWS[name], quiet=True,
                               backend=backend, device="cpu")
    got = {"ball": np.stack([r[0] for r in rows]),
           "cars": np.stack([r[1] for r in rows])}
    t0, t1 = WINDOWS[name]
    assert got["ball"].shape[0] == t1 - t0
    kind = f"teacher_{backend}"
    assert_rows_close(got, golden(kind, name), f"{kind} {name}")
    want = load_golden()[f"{kind}/{name}/worst"]
    assert np.allclose([worst[k] for k in sorted(worst)], want,
                       rtol=RTOL, atol=ATOL_LEN)


# ---------------------------------------------------------------------------
# the battery, the long gate and the debugging instruments

def test_battery_prints_the_table(monkeypatch, capsys):
    full = parity_battery.scenarios
    monkeypatch.setattr(parity_battery, "scenarios", lambda T: {
        n: s for n, s in full(T).items() if n == "ball_drop"})
    out = parity_battery.main("portable", 12, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["scenario", "car_pos", "car_vel", "car_ang",
                                "ball_pos", "ball_vel", "flags"]
    assert [ln.split()[0] for ln in lines[1:]] == ["ball_drop"]
    for ln, (name, e) in zip(lines[1:], out.items()):
        cols = ln.split()
        assert [float(c) for c in cols[1:6]] == pytest.approx(
            [round(e[k], 3) for k in ("car_pos", "car_vel", "car_ang",
                                      "ball_pos", "ball_vel")], abs=6e-3)
        assert e["flags"] == [] and len(cols) == 6
        # PARITY.md: exact on the XLA engine
        assert max(e[k] for k in ("car_pos", "car_vel", "car_ang",
                                  "ball_pos", "ball_vel")) < 1e-2
    with pytest.raises(ValueError, match="backend"):
        parity_battery.main("xla", 12, device="cpu")


def test_long_gate_holds_before_the_first_contact(capsys):
    """At 12 ticks the two kickoff cars have not met the ball or each
    other: every margin class holds on every tick (PARITY.md: the first
    class exceeded at tick 428 in the JAX engine's round 4)."""
    res = parity_battery.long_gate(12, device="cpu")
    assert set(res) == {"car_pos", "car_vel", "car_angvel", "ball_pos",
                        "ball_vel"}
    for name, r in res.items():
        assert r["within_pct"] == 100.0 and r["first_exceeded"] == -1, name
        assert r["max_err"] <= r["margin"], name
    out = capsys.readouterr().out
    assert out.startswith("LONG GATE: 12 ticks, seed 1234")


def test_long_gate_control_needs_the_plain_build(monkeypatch, tmp_path):
    missing = str(tmp_path / "build" / "rs_oracle")
    monkeypatch.setattr(parity, "ORACLE_BIN_O2", missing)
    with pytest.raises(FileNotFoundError, match=missing):
        parity_battery.long_gate(24, control=True, device="cpu")


def test_debug_dump_and_kdebug_rows(monkeypatch, capsys):
    ref = oracle_trace("car_ball_hit")
    got = batched("portable")[SCENARIOS.index("car_ball_hit")]
    parity_debug.dump(ref, got, 3, ["pos", "ball_vel"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[2].startswith("t=   2  pos: ref=")
    assert "torch=" in lines[2] and "ball_vel: ref=" in lines[2]
    monkeypatch.setattr(parity, "run_oracle", lambda scs, **kw: [ref])
    parity_kdebug.rows("car_ball_hit", T_TEACHER, 10, device="cpu")
    out = capsys.readouterr().out
    for head in ("== kernel facet/corner manifold", "== portable mesh "
                 "manifold + plane rows ==", " candidates (pre-retention):",
                 " retained slots (post internal-edge adjust):",
                 " plane rows:"):
        assert head in out, head
    # before the hit the ball rests on the floor: both routes hold one
    # floor row
    parity_kdebug.rows("car_ball_hit", T_TEACHER, 10, ball=True,
                       device="cpu")
    out = capsys.readouterr().out.replace("-0.", "0.")
    kernel, portable = out.split("== portable mesh sphere manifold ==")
    assert kernel.startswith("== kernel facet sphere manifold")
    for part in (kernel, portable):
        assert "slot0: n=[0. 0. 1.]" in part, part


def test_tools_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = parity_battery.scenarios(T_TRACE)["drive_forward"]
    for fn in (parity.run_torch, parity.run_torch_kernel):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn([sc])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity_kdebug.run_ctick(sc)


def test_command_lines_parse_their_options(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x", "drive_forward", "--device=cpu",
                                      "--oracle=/a/b", "--backend=kernel"])
    assert parity_battery.option("device") == "cpu"
    assert parity_battery.option("oracle") == "/a/b"
    assert parity_battery.option("backend") == "kernel"
    assert parity_battery.option("from", 3) == 3


if __name__ == "__main__":
    regenerate()
