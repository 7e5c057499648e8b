"""One run of one cell of the port's benchmark (see ``perfbench/run.py``).

A run loads the program's kernel (building it in a checkout's first run),
builds the cell's trainer through the program's own entry points, hands
it the benchmark's weights (drawn from the seed on the device), drives it
through three whole iterations while the probes capture what the
reference needs (the set-up, which also warms every shape the window
uses), then times whole iterations (whole cycles of iterations and one
skill match where the cell says so) for at least ``--seconds``; one env
step of the window's first skill match is captured.  One more iteration
after the window is captured with the program's state it started from.
With ``--trace 1`` the window carries the benchmark's spans, and one more
iteration runs under ``torch.profiler``.  Then the program is freed and
the reference follows the captures; the numbers it compares, each beside
its limit from the cell's file, decide ``correct``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import program
from perfbench import trace as tracemod
from perfbench.reference import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reinforcement_learning_tpu")
# where a cell that sets ``ts_per_save`` has the program save, by cell
CHECKPOINTS = ROOT / "build" / "perfbench_checkpoints"
CELL_KEYS = {"config", "why", "traffic", "window_unit", "limits"}
WINDOW_UNITS = ("iteration", "cycle")
CAPTURED_ITERATIONS = 3
WARM_MATCH_STEPS = 2       # the skill match's shapes, warmed in set-up
COUNTED_LAUNCH = 3         # the traced window's launch whose work is counted


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(workload: str) -> tuple:
    """(BENCHMARK.json, its workload entry, the cell's file, the
    configuration file), found by the workload's name."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"perfbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(entries)})")
    entry = entries[workload]
    cell = load_json(HERE / "cells" / f"{workload}.json")
    unknown = set(cell) - CELL_KEYS
    if unknown or cell["window_unit"] not in WINDOW_UNITS:
        raise SystemExit(f"perfbench: cells/{workload}.json: unknown keys "
                         f"{sorted(unknown)} or window_unit "
                         f"{cell['window_unit']!r} (one of {WINDOW_UNITS})")
    if cell["config"] != entry["config"]:
        raise SystemExit(f"perfbench: cells/{workload}.json names config "
                         f"{cell['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    return bench, entry, cell, config


def weight_shapes(config: dict) -> dict:
    """name -> shape of every parameter of the shared head, policy and
    critic, named as the program's ``PPOLearner`` names them."""
    ppo = config["ppo"]
    obs, actions = config["obs_size"], config["num_actions"]
    shared = list(ppo["shared_head_layers"])
    feat = shared[-1] if shared else obs
    models = {"shared_head": (obs, shared, 0)} if shared else {}
    models.update(policy=(feat, ppo["policy_layers"], actions),
                  critic=(feat, ppo["critic_layers"], 1))
    out = {}
    for name, (n_in, layers, n_out) in models.items():
        sizes = [n_in, *layers]
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out[f"{name}.layers.{i}.weight"] = (b, a)
            out[f"{name}.layers.{i}.bias"] = (b,)
            if ppo["layer_norm"]:
                out[f"{name}.norms.{i}.weight"] = (b,)
                out[f"{name}.norms.{i}.bias"] = (b,)
        if n_out:
            out[f"{name}.out.weight"] = (n_out, sizes[-1])
            out[f"{name}.out.bias"] = (n_out,)
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """The benchmark's weights: every Linear's weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one draw of a generator on
    the device seeded with ``seed``; LayerNorm's scale 1 and bias 0."""
    shapes = weight_shapes(config)
    linear = {k: s for k, s in shapes.items() if ".norms." not in k}
    total = sum(math.prod(s) for s in linear.values())
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    u = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for k, s in linear.items():
        n = math.prod(s)
        fan_in = shapes[k.rsplit(".", 1)[0] + ".weight"][1]
        out[k] = (u[at:at + n] / math.sqrt(fan_in)).reshape(s)
        at += n
    for k, s in shapes.items():
        if ".norms." in k:
            out[k] = (torch.ones(s, device=device) if k.endswith("weight")
                      else torch.zeros(s, device=device))
    return out


def card() -> str:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return "; ".join(out.splitlines()) if out else "nvidia-smi: no output"


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def iterate(trainer, state, device) -> tuple:
    """One ``train_iteration`` as ``Trainer.train`` drives it: a wait for
    the device, then the metrics read as floats.  Returns (state, whether
    every metric is finite)."""
    state, metrics = trainer.train_iteration(state)
    sync(device)
    values = [float(v) for v in metrics.values()]
    values += [float(v) for v in trainer.last_selfplay_metrics.values()]
    return state, all(math.isfinite(v) for v in values)


def _force_match(trainer, steps: int):
    """Make the next iteration end in a skill match of ``steps`` env
    steps; returns the match's own length, to restore."""
    tracker = trainer.skill_tracker
    tracker.iterations_since_ran = trainer.selfplay.skill.update_interval - 1
    full, tracker.steps_per_run = tracker.steps_per_run, steps
    return full


def _end_match(trainer, full_steps: int):
    """Restore the match's length and start the next cycle afresh."""
    tracker = trainer.skill_tracker
    tracker.steps_per_run = full_steps
    tracker.iterations_since_ran = 0
    tracker.continuation, tracker.env_states, tracker.cur_goals = (
        False, None, 0)


def setup(trainer, probe, weights, device, place=None) -> tuple:
    """Hand the trainer the benchmark's weights, then drive it through
    the captured iterations (a short skill match in the last where the
    cell plays them).  ``place(state)``: the first state put where it
    runs (a data-parallel rank's block).  Returns (state, capture)."""
    trainer.learner.load_state_dict(weights, strict=True)
    state = trainer.init()
    if place is not None:
        state = place(state)
    with probe.capturing(0) as cap:
        for i in range(CAPTURED_ITERATIONS):
            full = None
            if (trainer.skill_tracker is not None
                    and i == CAPTURED_ITERATIONS - 1):
                full = _force_match(trainer, WARM_MATCH_STEPS)
            t0 = time.perf_counter()
            state, _ = iterate(trainer, state, device)
            cap.setdefault("iteration_s", []).append(time.perf_counter() - t0)
            if full is not None:
                _end_match(trainer, full)
    return state, cap


def arm_match(probe, seed: int, size):
    """Await one env step of the window's first skill match, drawn from
    the seed among the ``size[0]`` steps the cell's match has."""
    if size is not None:
        probe.match_capture = {
            "step": random.Random(f"match {seed}").randint(1, size[0])}


def window(trainer, probe, state, unit: int, seconds: float,
           device) -> dict:
    """Whole units of ``unit`` iterations until ``seconds`` have
    passed; with a checkpoint folder, a save every ``ts_per_save`` steps,
    as ``Trainer.train`` saves."""
    failed, times = 0, []
    saves, last_save = trainer.config.ts_per_save, state.total_timesteps
    probe.phase = "window"
    t0 = time.perf_counter()
    while True:
        for _ in range(unit):
            t = time.perf_counter()
            state, ok = iterate(trainer, state, device)
            if (trainer.config.checkpoint_folder
                    and state.total_timesteps - last_save >= saves):
                trainer.save(state)
                last_save = state.total_timesteps
            times.append(time.perf_counter() - t)
            failed += not ok
        # rank 0's clock ends a data-parallel window on every rank
        if trainer.env.shard.from_root(time.perf_counter() - t0 >= seconds,
                                       device):
            break
    elapsed = time.perf_counter() - t0
    probe.phase = "after"
    print("perfbench: window's iterations (s): " + ", ".join(
        f"{t:.3f}" for t in times), file=sys.stderr)
    return dict(state=state, seconds=elapsed, iterations=len(times),
                failed=failed, player_steps=len(times)
                * trainer.steps_per_itr * trainer.players_per_step)


def after_window(trainer, probe, state, seed: int, device,
                 record: bool = True) -> tuple:
    """One more iteration, captured with where it started from, so that
    the reference follows the timed path as the window left it; its env
    step whose physics is recorded (unless not ``record``) is drawn from
    the seed.  Returns (state, capture)."""
    step = probe.launches + random.Random(f"after {seed}").randint(
        1, trainer.steps_per_itr) if record else 0
    with probe.capturing(step, from_program=True) as cap:
        state, _ = iterate(trainer, state, device)
    return state, cap


def traced(trainer, probe, state, config: dict, size, device,
           count: bool = True) -> dict:
    """The tensor ops of one env step under the frozen dispatch counter,
    then one iteration under ``torch.profiler`` (ending, where the cell
    plays skill matches, in a match of its steps over the iterations of a
    cycle, so that the traced mix is the cycle's), reduced; and the work
    of one of its kernel launches, counted by the frozen plain step on
    that launch's inputs.  Without ``count`` (a data-parallel rank other
    than 0, which runs the same calls) the trace's reduction alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.reference.rlt.ops import opcount

    counter = opcount._Counter()
    probe.count_ops = counter if count else None
    trainer.collect(state, T=1)
    sync(device)
    ops_per_step = counter.calls

    counted = min(COUNTED_LAUNCH, trainer.steps_per_itr)
    if count:
        probe.launch_inputs = (probe.launches + counted, None)
    full = None
    if size is not None:
        every = trainer.selfplay.skill.update_interval
        full = _force_match(trainer, -(-size[0] // every))
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function("perfbench.window"):
            trainer.train_iteration(state)
            sync(device)
    if full is not None:
        _end_match(trainer, full)
    reduced = tracemod.reduce(prof, "perfbench.window", "arena_step",
                              program.SPANS)
    del prof
    if not count:
        return dict(trace=reduced)
    launch = probe.launch_inputs[1]
    probe.launch_inputs = None
    phys = check.rebuild(program.to_plain(launch["phys"]), device)
    ref = check.envmod.RefEnv(config, device)
    work = opcount.step_work(phys, launch["controls"],
                             launch["respawn_idx"], ref.consts,
                             ref.tick_skip, ref.action_delay)
    nbytes = sum(t.numel() * t.element_size() for t in
                 _tensors([launch["phys"], launch["out"],
                           launch["controls"], launch["respawn_idx"]]))
    kernel = reduced["kernel_launches"]
    # the training launches come first: a match steps after the update
    kernel_s = kernel[counted - 1] if len(kernel) >= counted else None
    return dict(trace=reduced, ops_per_step=ops_per_step,
                launch=dict(ops=work.ops_needed, bytes=nbytes,
                            kernel_s=kernel_s),
                training_launch_s=kernel[:trainer.steps_per_itr])


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _tensors(getattr(x, name))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def read_metrics(bench: dict, workload: str, data: dict) -> dict:
    """The per-layer metrics that apply to ``workload``, each read by its
    own file under ``metrics/``; a reader that finds nothing returns None
    and its metric is left out."""
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        path = HERE / "metrics" / f"{m['name']}.py"
        spec_ = importlib.util.spec_from_file_location(
            f"perfbench_metric_{len(out)}", path)
        module = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(module)
        value = module.read(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def load_kernel(device) -> None:
    """Build (in a checkout's first run) and load the program's kernel,
    so that its seconds show apart in the set-up's phases."""
    if torch.device(device).type == "cuda":
        from reinforcement_learning_torch.ops import arena_step
        arena_step._library()


def replica(trainer) -> dict:
    """The learner's parameters and optimiser states as CPU tensors by
    name: what every rank of a data-parallel run holds alike."""
    learner = trainer.learner
    out = {f"param.{k}": v for k, v in learner.named_parameters()}
    for name, (model, _) in learner._models().items():
        opt = learner.optimizers[name]
        for k, p in (model.named_parameters() if opt is not None else ()):
            out.update({f"optim.{name}.{k}.{key}": v
                        for key, v in opt.state[p].items()
                        if isinstance(v, torch.Tensor)})
    return program.to_plain(out)


def all_sum_calls() -> int:
    """The port's count of its all-reduces (``EnvShard.all_sum``), which
    its tracer keeps with the spans off."""
    from reinforcement_learning_torch.utils import tracing
    return tracing.summary()["counters"].get("shard.all_sum.calls", 0)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", started: float | None = None,
        shrink=None, mesh=None, gloo=None, control: bool = False):
    """One run; returns the result line's object.  ``started``: the
    process's start on ``time.perf_counter``'s clock.  ``shrink(config,
    cell)``: edits the configuration and cell in place (the CPU tests'
    tiny sizes).  ``mesh``: this process is one rank of the cell's
    data-parallel run on that device mesh (``perfbench/rank.py``), its
    captures gathered to rank 0 over the process group ``gloo``; rank 0
    returns the result, the others None.  ``control``: the result also
    holds the control's numbers (``perfbench/readings.py``)."""
    started = time.perf_counter() if started is None else started
    bench, entry, cell, config = spec(workload)
    if shrink is not None:
        shrink(config, cell)
    ranks = program.ranks(cell["traffic"])
    if (mesh.size() if mesh is not None else 1) != ranks:
        raise SystemExit(f"perfbench: {workload} runs on {ranks} ranks, "
                         f"this run has {mesh.size() if mesh else 1}")
    if mesh is not None:
        config = program.global_config(config, ranks)
    phases = {"start": time.perf_counter() - started}
    load_kernel(device)
    phases["kernel"] = time.perf_counter() - started
    trainer = program.build(config, cell["traffic"], seed, device,
                            str(CHECKPOINTS / workload))
    probe = program.Probe(trainer, spans=trace, draws=mesh is not None)
    weights = make_weights(config, seed, device)
    sync(device)
    phases["build"] = time.perf_counter() - started
    place = None
    if mesh is not None:
        from reinforcement_learning_torch.parallel import mesh as meshmod

        def place(state):
            return meshmod.shard_train_state(trainer, state, mesh)
    state, cap = setup(trainer, probe, weights, device, place)
    sync(device)
    shard = trainer.env.shard
    root = shard.rank == 0
    # the env steps compared with the reference: rank 0's and the last's
    recorded = shard.rank in (0, ranks - 1)
    if mesh is not None:
        replicas = [replica(trainer)]
        shard.from_root(True, device)   # every rank at the window's start
    setup_s = time.perf_counter() - started
    phases["iterations"] = setup_s
    print("perfbench: set-up reached (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) + "; its iterations "
        + ", ".join(f"{v:.3f}" for v in cap["iteration_s"])
        + "; the kernel's build and load "
        + f"{phases['kernel'] - phases['start']:.3f}", file=sys.stderr)

    size = program.match_size(config, cell["traffic"])
    every = (trainer.selfplay.skill.update_interval if size is not None
             else 1)
    unit = every if cell["window_unit"] == "cycle" else 1
    probe.spans.clear()
    probe.rows.clear()
    arm_match(probe, seed, size)
    calls, arena_steps = all_sum_calls(), probe.arena_steps
    win = window(trainer, probe, state, unit, seconds, device)
    calls, arena_steps = (all_sum_calls() - calls,
                          probe.arena_steps - arena_steps)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = {k: list(v) for k, v in probe.spans.items()}
    rows = dict(probe.rows)
    if mesh is not None:
        replicas.append(replica(trainer))
    state, post = after_window(trainer, probe, win.pop("state"), seed,
                               device, record=recorded)
    matches = list(probe.matches)
    tr = (traced(trainer, probe, state, config, size, device, count=root)
          if trace else None)
    cars = trainer.env.config.cars_per_arena
    probe.remove()
    del trainer, probe, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    extra, count = {}, 1
    if mesh is not None:
        mine = dict(cap=cap, post=post, replicas=replicas, peak=peak,
                    rows=rows, arena_steps=arena_steps, offset=shard.offset,
                    busy=tr and (tr["trace"]["busy_s"],
                                 tr["trace"]["window_s"]),
                    allreduce=tr and tr["trace"]["allreduce_launches"])
        parts = [None] * ranks if root else None
        torch.distributed.gather_object(mine, parts, dst=0, group=gloo)
        del mine
        if not root:
            return None
        cap = check.gathered([r["cap"] for r in parts])
        post = check.gathered([r["post"] for r in parts])
        post["blocks"] = check.blocks([r["post"] for r in parts],
                                      [r["offset"] for r in parts])
        peak = max(r["peak"] for r in parts)
        rows = {k: sum(r["rows"].get(k, 0) for r in parts) for k in rows}
        steps = [r["arena_steps"] for r in parts]
        win["player_steps"] = sum(steps) * cars
        extra = {"replica_gap": check.replica_gap(
                     [r["replicas"] for r in parts]),
                 "rank_steps_off": check.rank_steps_off(steps)}
        if trace:
            busy = [r["busy"] for r in parts]
            tr["trace"]["busy_s"] = sum(b for b, _ in busy) / ranks
            tr["trace"]["window_s"] = sum(w for _, w in busy) / ranks
            tr["allreduce_launches"] = [r["allreduce"] for r in parts]
        count = ranks
        del parts
        gc.collect()

    expected = win["iterations"] // every if size is not None else 0
    numbers = check.numbers(config, weights, cap, post, matches, size,
                            expected, device,
                            draw_envs=config["env"]["num_envs"]
                            if mesh is not None else None)
    numbers.update(extra)
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    names = {m["name"]: m for m in bench["end_to_end"]}
    if not trace:
        metrics["player_steps_per_s"] = {
            "value": win["player_steps"] / win["seconds"],
            "unit": names["player_steps_per_s"]["unit"]}
        metrics["setup_s"] = {"value": setup_s,
                              "unit": names["setup_s"]["unit"]}
    result = {"correct": correct, "attempted": win["iterations"],
              "failed": win["failed"], "metrics": metrics}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": count, "memory_peak_bytes": peak}
    if trace:
        data = dict(spans=spans, rows=rows, window_s=win["seconds"],
                    config=config, chips=count,
                    all_sum_calls=calls / win["iterations"], **tr)
        result["metrics"] = read_metrics(bench, workload, data)
        device_info["busy_s"] = tr["trace"]["busy_s"]
        device_info["window_s"] = tr["trace"]["window_s"]
        result["breakdown"] = {"device_ops": tr["trace"]["device_ops"],
                               "idle_gaps": tr["trace"]["idle_gaps"]}
    result["device"] = device_info
    if control:
        result["control"] = check.control_numbers(config, weights, cap,
                                                  post, matches, device)
    result["checks"] = checks
    return result


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def report(result: dict) -> int:
    """Print a run's result as the driver reads it: the cards on standard
    error, then each number compared beside its limit as the last lines
    there, and the result's line last on standard output.  Returns 1, and
    prints no result, where this process has loaded JAX or the JAX
    package."""
    print(f"perfbench: {card()}", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: loaded in this process: {found}",
              file=sys.stderr)
        return 1
    if not result["correct"]:
        print("perfbench: correct is false", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv: list, started: float) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _, entry, _, _ = spec(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    if entry["chips"] > 1:
        from perfbench import launch
        return launch.main(args, entry["chips"], started)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 "cuda", started)
    return report(result)
