"""The numbers that decide ``correct``: what the program's timed path
produced, against the plain reference following it.  Every function takes
what the harness captured (nested dicts of CPU tensors, see
``perfbench/program.py``) and the benchmark's own inputs (the
configuration file, the weights it made); nothing here imports the
program.

Where the reference can only follow the program from the program's own
state, it does: the physics and the post-physics of an env step start
from the state the program stepped from (one step of the iteration after
the window, and one of the window's first skill match); the update learns
from the rows the program collected; the iteration after the window
starts from the program's parameters, optimiser states and return
statistic there; a match's log-probabilities are taken with the
parameters the program sampled with.  The set-up's three iterations chain
the reference's own parameters, optimiser states and return statistic
from the benchmark's weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.reference import env as envmod
from perfbench.reference.ppo import RefLearner, matmul_precision
from perfbench.reference.rlt.envs import events, terminals
from perfbench.reference.rlt.learn import welford
from perfbench.reference.rlt.ops import ctick
from perfbench.reference.rlt.physics import state, step

CLASSES = {c.__name__: c for mod in (envmod, events, welford, state,
                                     step)
           for c in vars(mod).values()
           if isinstance(c, type) and dataclasses.is_dataclass(c)
           and c.__module__ == mod.__name__}

# post-physics floats: the same arithmetic on the same inputs, so float32
# rounding at most
ENV_TOLERANCE = (1e-5, 1e-5)
# a leaf whose first gradient is under this share of the median leaf's
# moves under Adam by round-off alone
STILL_LEAF = 1e-3


def rebuild(plain, device):
    """The reference's own objects from a captured state."""
    if isinstance(plain, dict) and "__class__" in plain:
        cls = CLASSES[plain["__class__"]]
        return cls(**{f.name: rebuild(plain[f.name], device)
                      for f in dataclasses.fields(cls)})
    if isinstance(plain, torch.Tensor):
        return plain.to(device)
    if isinstance(plain, dict):
        return {k: rebuild(v, device) for k, v in plain.items()}
    if isinstance(plain, (list, tuple)):
        return type(plain)(rebuild(v, device) for v in plain)
    return plain


def _leaves(x, prefix=""):
    if isinstance(x, dict):
        for k, v in x.items():
            if k != "__class__":
                yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(x, torch.Tensor):
        yield prefix[:-1], x


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def physics_off_share(ref: envmod.RefEnv, cap: dict) -> float:
    """Share of the arenas whose next state from the kernel differs from
    the plain step's: a flag, an integer or an event timer differs, or a
    float lies beyond its tolerance (``ops/ctick.py``'s table) or is not
    finite."""
    dev = ref.device
    want = ref.physics_step(rebuild(cap["phys"], dev),
                            cap["controls"].to(dev),
                            cap["respawn_idx"].to(dev))
    got = dict(_leaves(cap["out"]))
    n = cap["controls"].shape[0]
    off = torch.zeros(n, dtype=torch.bool)
    for k, a in _leaves(_plain(want)):
        a, g = a.cpu(), got[k]
        if a.dtype.is_floating_point:
            atol, rtol = ctick.TOLERANCES.get(k, ctick.DEFAULT_TOLERANCE)
            bad = ((g - a).abs() > atol + rtol * a.abs()) | ~torch.isfinite(g)
        else:
            bad = g != a
        off |= bad.reshape(n, -1).any(-1)
    return float(off.float().mean())


def env_off_arenas(ref: envmod.RefEnv, cap: dict) -> torch.Tensor:
    """The arenas whose post-physics outputs (observation before and after
    the reset, reward, terminal, action mask, touch, goal) differ from the
    reference's, the reset drawn from the program's generator state."""
    dev = ref.device
    ref.generator.set_state(cap["generator"])
    _, out = ref.post_physics(rebuild(cap["state"], dev),
                              rebuild(cap["phys"], dev),
                              cap["controls"].to(dev))
    got = cap["out"]
    n = cap["controls"].shape[0]
    off = torch.zeros(n, dtype=torch.bool)
    atol, rtol = ENV_TOLERANCE
    for k in ("obs", "final_obs", "reward", "terminal_type", "action_mask",
              "ball_touched", "goal_scored"):
        a, g = getattr(out, k), got[k]
        if a is None or g is None:   # a skill match's env has no rewards
            if (a is None) != (g is None):
                return torch.ones(n, dtype=torch.bool)
            continue
        a = a.cpu()
        if a.dtype.is_floating_point:
            bad = ((g - a).abs() > atol + rtol * a.abs()) | ~torch.isfinite(g)
        else:
            bad = g != a
        off |= bad.reshape(n, -1).any(-1)
    return off


def env_off_share(ref: envmod.RefEnv, cap: dict) -> float:
    """Share of the arenas of ``env_off_arenas``."""
    return float(env_off_arenas(ref, cap).float().mean())


def draw_off(ref: envmod.RefEnv, block: dict) -> int:
    """Arenas of a data-parallel rank's block, at its recorded env step,
    that did not keep the rank's own block of the draws made at the global
    width: the respawn indices differ from the reference's draw for the
    block (from the program's generator state before it), or the arena
    reset and its post-physics outputs differ from the reference's (the
    reset drawn at the global width, the block kept)."""
    physics = block["physics"]
    n = physics["controls"].shape[0]
    ref.generator.set_state(block["respawn_generator"])
    idx = ref.respawn_idx(n).cpu()
    off = (idx != physics["respawn_idx"]).reshape(n, -1).any(-1)
    post = block["post_physics"]
    reset = post["out"]["terminal_type"] != terminals.NOT_TERMINAL
    off |= reset & env_off_arenas(ref, post)
    return int(off.sum())


def learn_chain(config: dict, start: dict, iterations: list, device,
                tf32: bool = False) -> dict:
    """The reference's learning half over captured iterations: from
    ``start`` (``params``, and where the program's state is followed its
    ``optimizers`` and ``return_stat``; else fresh ones), each
    iteration's values, GAE, return statistic and update on the rows the
    program collected, with the program's permutations.  ``tf32``: the
    matrix products in TF32 (the control)."""
    learner = RefLearner(config, start["params"], device)
    if start.get("optimizers") is not None:
        learner.load_optimizers(start["optimizers"])
    stat = (rebuild(start["return_stat"], device)
            if start.get("return_stat") is not None
            else welford.WelfordState.make((), device))
    ppo, tc = config["ppo"], config["trainer"]
    out = dict(losses=[], first_grad=None, params_before=[], adv=[],
               target=[], return_std=[], return_count=[])
    with matmul_precision(tf32):
        for it in iterations:
            out["params_before"].append(learner.params())
            traj = {k: v.to(device) for k, v in it["traj"].items()}
            data, stat = learner.prepare(
                traj, stat, ppo["gae_gamma"], ppo["gae_lambda"],
                ppo["reward_clip_range"], tc["standardize_returns"])
            if it["weight"] is not None:
                data["weight"] = it["weight"].to(device)
            out["adv"].append(data["advantage"].cpu())
            out["target"].append(data["target_value"].cpu())
            out["return_std"].append(float(stat.std))
            out["return_count"].append(float(stat.count))
            gen = torch.Generator(device=device)
            gen.set_state(it["generator"])
            losses, grads = learner.update(data, gen)
            out["losses"] += losses
            if out["first_grad"] is None:
                out["first_grad"] = {k: g.cpu() for k, g in grads[0].items()}
    out["params_after"] = {k: v.cpu() for k, v in learner.params().items()}
    return out


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def _leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap of norms, over the larger of its reference
    norm and the median leaf's."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    median = sorted(norms.values())[len(norms) // 2]
    gap = 0.0
    for k, n in norms.items():
        if keep is not None and k not in keep:
            continue
        g = got.get(k)
        if g is None:
            return math.inf
        g = float(g.norm())
        gap = max(gap, abs(g - n) / max(n, median, 1e-30)
                  if math.isfinite(g) else math.inf)
    return gap


def learn_numbers(program: dict, chain: dict, weights: dict) -> dict:
    """``program``: the program's side, in the keys ``learn_chain``
    returns (losses, first_grad, params_after, adv, target, return_std,
    return_count); ``weights``: the parameters the chain started from.
    No ``grad1_gap`` where the program's first gradient is None (a chain
    that starts from optimiser states)."""
    if len(program["losses"]) != len(chain["losses"]):
        loss_gap = math.inf
    else:
        # relative where a loss exceeds 1, absolute below: a PPO loss
        # may pass through 0
        loss_gap = max(_rel(a, b, 1.0) for a, b in
                       zip(program["losses"], chain["losses"]))
    first = chain["first_grad"]
    norms = {k: float(v.norm()) for k, v in first.items()}
    median = sorted(norms.values())[len(norms) // 2]
    moving = {k for k, n in norms.items() if n >= STILL_LEAF * median}
    change_p = {k: v - weights[k].cpu()
                for k, v in program["params_after"].items()}
    change_r = {k: v - weights[k].cpu()
                for k, v in chain["params_after"].items()}
    gae = 0.0
    for key in ("adv", "target"):
        for p, r in zip(program[key], chain[key]):
            gae = max(gae, float((p - r).abs().max())
                      / max(float(r.std()), 1e-12))
    welford_gap = max(
        [_rel(a, b, 1e-12) for a, b in zip(program["return_std"],
                                            chain["return_std"])]
        + [abs(a - b) for a, b in zip(program["return_count"],
                                       chain["return_count"])])
    out = {"loss_gap": loss_gap,
           "change_gap": _leaf_gap(change_p, change_r, moving),
           "gae_gap": gae, "welford_gap": welford_gap}
    if program["first_grad"] is not None:
        out["grad1_gap"] = _leaf_gap(program["first_grad"], first)
    return out


def logp_gap(cap: dict, chain: dict, config: dict, device,
             program_side=None) -> float:
    """The widest gap between the log-probability the program sampled
    each action with (bf16 inference) and the reference's in float32 with
    its parameters at that iteration, over the rows the update weighs,
    each in units of its row's logit scale (``RefLearner.logit_scale``):
    bf16's rounding grows with the logits as the policy sharpens over a
    window.  ``program_side(learner, obs, mask, action)`` stands in for
    the program's (the control)."""
    gap = 0.0
    for it, params in zip(cap["iterations"], chain["params_before"]):
        learner = RefLearner(config, params, device)
        traj = it["traj"]
        obs = traj["obs"].to(device).reshape(-1, traj["obs"].shape[-1])
        mask = traj["mask"].to(device).reshape(-1, traj["mask"].shape[-1])
        action = traj["action"].to(device).reshape(-1)
        want = learner.logp(obs, mask, action)
        got = (traj["old_logp"].to(device).reshape(-1) if program_side is None
               else program_side(learner, obs, mask, action))
        d = (got - want).abs() / learner.logit_scale(obs, mask)
        d[~torch.isfinite(d)] = math.inf
        if it["weight"] is not None:
            # an old version's rows: the action taken is the old
            # version's, the log-probability the current policy's own
            # sample's, and the update gives them no weight
            d = d[it["weight"].to(device) > 0]
        gap = max(gap, float(d.max()))
    return gap


def fp8_inference(learner: RefLearner, obs, mask, action):
    """The control of bf16 inference: the next precision below it, each
    weight matrix rounded to float8 (e4m3, scaled per tensor to its
    range), the layers in bf16."""
    with torch.no_grad():
        for model in learner.models.values():
            for lin in list(model.layers) + ([model.out] if model.out
                                             else []):
                w = lin.weight
                scale = 448.0 / w.abs().max().clamp(min=1e-30)
                w.copy_((w * scale).to(torch.float8_e4m3fn).float() / scale)
    return learner.logp(obs, mask, action, half=True)


def match_logp_gap(match: dict, config: dict, weights: dict, device,
                   program_side=None) -> float:
    """The widest gap between the log-probability each side of the
    captured skill-match step sampled with and the reference's in float32
    with the parameters the program sampled with (the learner's and the
    old version's, the program's state), in units of the row's logit
    scale as ``logp_gap``."""
    gap = 0.0
    for s in match["samples"]:
        params = dict(weights, **s["params"])   # the critic is not used
        learner = RefLearner(config, params, device)
        obs, mask = s["obs"].to(device), s["mask"].to(device)
        action = s["action"].to(device)
        want = learner.logp(obs, mask, action)
        got = (s["logp"].to(device) if program_side is None
               else program_side(learner, obs, mask, action))
        d = (got - want).abs() / learner.logit_scale(obs, mask)
        d[~torch.isfinite(d)] = math.inf
        gap = max(gap, float(d.max()))
    return gap


def match_off(matches: list, size: tuple, expected: int) -> int:
    """How far the window's skill matches are from the cell's: matches
    missing or extra against one a cycle, and matches whose env steps or
    arenas differ from the cell's files."""
    played = [m for m in matches if m["phase"] == "window"]
    return abs(len(played) - expected) + sum(
        (m["steps"], m["arenas"]) != tuple(size) for m in played)


def goals(match: dict) -> tuple:
    """(goals of the current policy, of the old version) from the goal
    events of each step of a match: the net is read from the ball the
    goal was read from (after the goal's reset, the kickoff ball at y = 0:
    the orange net), the side from the team the current policy played."""
    if not match["events"]:
        return 0, 0
    ev = torch.stack([e.cpu() for e in match["events"]])
    scored = ~torch.isnan(ev)
    on_team = torch.where(ev < 0, 0, 1)
    new = int((scored & (on_team != match["new_team"])).sum())
    return new, int((scored & (on_team == match["new_team"])).sum())


def elo_gap(matches: list) -> float:
    """The widest gap between the ratings the program wrote after each
    skill match and the ELO rule applied to the goals of that match's
    events."""
    gap = 0.0
    for m in matches:
        if m["idx"] is None:   # no version to play: nothing is rated
            gap = max(gap, float((m["after"] - m["before"]).abs().max()))
            continue
        cur, old = float(m["before"][m["last"]]), float(m["before"][m["idx"]])
        new_goals, old_goals = goals(m)
        for _ in range(new_goals):
            cur, old = _elo(cur, old, m["inc"])
        for _ in range(old_goals):
            old, cur = _elo(old, cur, m["inc"])
        want = m["before"].clone()
        want[m["idx"]] = old
        want[m["last"]] = cur
        gap = max(gap, float((m["after"] - want).abs().max()))
    return gap


def _elo(winner: float, loser: float, inc: float):
    """PolicyVersionManager.cpp:159-169."""
    expected = 1.0 / (10.0 ** ((loser - winner) / 400.0) + 1.0)
    return winner + inc * (1.0 - expected), loser - inc * (1.0 - expected)


def program_side(cap: dict) -> dict:
    """The program's side of ``learn_numbers`` from a capture (no first
    gradient where the capture starts from the program's state)."""
    its = cap["iterations"]
    first = None
    if not cap["from_program"]:
        first = {f"{n}.{k}": v for n, leaves in cap["first_grad"].items()
                 for k, v in leaves.items()}
    return dict(
        losses=[x for it in its for x in it["losses"]],
        first_grad=first, params_after=cap["params_after"],
        adv=[it["advantage"] for it in its],
        target=[it["target_value"] for it in its],
        return_std=[float(rebuild(it["return_stat"], "cpu").std)
                    for it in its],
        return_count=[float(it["return_stat"]["count"]) for it in its])


def _worst(*numbers: dict) -> dict:
    out = {}
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def _chains(config: dict, weights: dict, cap: dict, post: dict, device,
            tf32: bool = False) -> tuple:
    """The reference's learning half over the set-up's iterations (from
    the benchmark's weights) and over the iteration after the window
    (from the program's state there)."""
    start = post["iterations"][0]["start"]
    return (learn_chain(config, dict(params=weights), cap["iterations"],
                        device, tf32),
            learn_chain(config, start, post["iterations"], device, tf32),
            start["params"])


def numbers(config: dict, weights: dict, cap: dict, post: dict,
            matches: list, size, expected: int, device,
            draw_envs: int | None = None) -> dict:
    """Every number of a run, program against reference.  ``cap``: the
    set-up's iterations; ``post``: the iteration after the window;
    ``matches``: every skill match; ``size``: the cell's match (env
    steps, arenas), or None; ``expected``: matches the window owes;
    ``draw_envs``: a data-parallel run's global arenas, whose recorded env
    steps are ``post["blocks"]`` (see ``blocks``), each compared with the
    reference's draws for its block, which ``draw_off`` counts."""
    with matmul_precision(False):
        physics, env, drawn = [], [], 0
        for b in post.get("blocks") or [dict(offset=0, **post)]:
            ref = envmod.RefEnv(config, device, draw_envs=draw_envs,
                                offset=b["offset"])
            physics.append(physics_off_share(ref, b["physics"]))
            env.append(env_off_share(ref, b["post_physics"]))
            if draw_envs is not None:
                drawn += draw_off(ref, b)
        chain, chain_post, start = _chains(config, weights, cap, post,
                                           device)
        out = _worst(learn_numbers(program_side(cap), chain, weights),
                     learn_numbers(program_side(post), chain_post, start))
        logp = [logp_gap(cap, chain, config, device),
                logp_gap(post, chain_post, config, device)]
        if size is not None:
            out["match_off"] = match_off(matches, size, expected)
            out["elo_gap"] = elo_gap(matches)
            taken = [m["capture"] for m in matches if "capture" in m]
            if not taken:
                out["match_off"] += 1   # the awaited step never came
            for c in taken:
                ref = envmod.RefEnv(config, device, match=True)
                physics.append(physics_off_share(ref, c["physics"]))
                env.append(env_off_share(ref, c["post_physics"]))
                logp.append(match_logp_gap(c, config, weights, device))
        out.update(physics_off=max(physics), env_off=max(env),
                   logp_gap=max(logp))
        if draw_envs is not None:
            out["draw_off"] = drawn
    return out


def control_numbers(config: dict, weights: dict, cap: dict, post: dict,
                    matches: list, device) -> dict:
    """The control's numbers: the reference in the program's place, in the
    next precision below the configuration's (the update's products in
    TF32, the inference's weights in float8), against the reference."""
    chain, chain_post, start = _chains(config, weights, cap, post, device)
    low, low_post, _ = _chains(config, weights, cap, post, device, True)
    low_post["first_grad"] = None   # as the program's side of that chain
    out = _worst(learn_numbers(low, chain, weights),
                 learn_numbers(low_post, chain_post, start))
    with matmul_precision(False):
        logp = [logp_gap(cap, chain, config, device,
                         program_side=fp8_inference),
                logp_gap(post, chain_post, config, device,
                         program_side=fp8_inference)]
        logp += [match_logp_gap(m["capture"], config, weights, device,
                                program_side=fp8_inference)
                 for m in matches if "capture" in m]
    out["logp_gap"] = max(logp)
    return out


def gathered(caps: list) -> dict:
    """One capture of a data-parallel run's iterations from every rank's
    (in rank order): each iteration's rows over the global arenas (a
    rank's block of arenas follows the one before), its losses summed (each
    rank's is its rows' share of the global mean), and rank 0's of what
    every rank holds alike (the first gradient, parameters, optimiser
    states, return statistic and permutations, all after the all-reduces).
    The env steps that ranks recorded are ``blocks``'."""
    out = dict(caps[0])
    its = []
    for parts in zip(*(c["iterations"] for c in caps)):
        it = dict(parts[0])
        T = it["traj"]["action"].shape[0]
        it["traj"] = {k: torch.cat([p["traj"][k] for p in parts], 1)
                      for k in it["traj"]}
        for k in ("advantage", "target_value", "weight"):
            if it.get(k) is not None:
                it[k] = torch.cat([p[k].reshape(T, -1) for p in parts],
                                  1).reshape(-1)
        it["losses"] = [sum(xs) for xs in zip(*(p["losses"]
                                                for p in parts))]
        its.append(it)
    out["iterations"] = its
    return out


def blocks(posts: list, offsets: list) -> list:
    """The env steps that a data-parallel run's ranks recorded (rank 0's
    and the last's), each with the first arena of its rank's block: the
    kernel's step, the post-physics and the generator's state before the
    respawn draw."""
    keys = ("physics", "post_physics", "respawn_generator")
    return [dict(offset=at, **{k: p[k] for k in keys})
            for p, at in zip(posts, offsets) if "physics" in p]


def replica_gap(replicas: list) -> float:
    """The largest difference between any rank's parameters and optimiser
    states and rank 0's, at each point they were read (``replicas``: per
    rank, a list of name -> tensor); inf where a name is missing or the
    difference is not finite.  The ranks step the same all-reduced
    gradients, so they hold the same bits: 0."""
    gap = 0.0
    for other in replicas[1:]:
        if len(other) != len(replicas[0]):
            return math.inf
        for mine, root in zip(other, replicas[0]):
            if mine.keys() != root.keys():
                return math.inf
            for k, a in root.items():
                d = (mine[k].double() - a.double()).abs()
                d[~torch.isfinite(d)] = math.inf
                gap = max(gap, float(d.max()) if d.numel() else 0.0)
    return gap


def rank_steps_off(arena_steps: list) -> int:
    """Ranks whose window stepped another count of env steps x arenas than
    rank 0's."""
    return sum(s != arena_steps[0] for s in arena_steps[1:])
