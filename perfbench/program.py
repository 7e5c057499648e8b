"""The system under test: the port's ``Trainer`` built from a
configuration file and a cell's traffic, and the benchmark's probes around
the calls into each layer.

The probes are instance attributes (and, for the kernel's entry, the env
module's name for it) that wrap the program's own calls and restore them
when removed.  They record spans and row counts in a traced run, and,
while the set-up drives the first iterations, what the reference needs to
follow them: the collected rows, the update's inputs, losses and first
gradient, one env step's physics and post-physics in and out, and the
skill matches' ratings.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from collections import defaultdict

import torch

SPANS = ("trainer.collect", "trainer.learn", "selfplay.match", "env.step",
         "ppo.sample")


def _resolve(ref: str):
    module, attr = ref.split(":")
    return getattr(importlib.import_module(module), attr)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def to_plain(x):
    """A program state as nested dicts of CPU tensors, each dataclass
    tagged with its class name, so that the reference rebuilds it from its
    own classes."""
    if dataclasses.is_dataclass(x):
        out = {f.name: to_plain(getattr(x, f.name))
               for f in dataclasses.fields(x)}
        out["__class__"] = type(x).__name__
        return out
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_plain(v) for v in x)
    return x


# the keys a configuration file, its ``env``, a cell file and its
# ``traffic`` may hold; any other is refused, not ignored
CONFIG_KEYS = {"name", "source", "deployment", "program", "scale", "env",
               "obs", "action_parser", "obs_size", "num_actions", "rewards",
               "terminals", "state_setter", "state_setter_kwargs", "ppo",
               "trainer", "selfplay", "params", "precision", "assumed",
               "reduced"}
ENV_KEYS = {"num_envs", "team_size", "tick_skip", "action_delay",
            "no_touch_timeout", "max_episode_seconds", "game_mode",
            "use_mesh", "dynamic_wheel_rays"}
TRAFFIC_KEYS = {"skill_interval", "old_opponent_chance", "match_arenas",
                "match_sim_seconds", "ts_per_save", "checkpoints_to_keep"}


def check_keys(config: dict, traffic: dict):
    """Raise on a key that the benchmark would not act on."""
    bad = {"config": set(config) - CONFIG_KEYS,
           "config env": set(config["env"]) - ENV_KEYS,
           "traffic": set(traffic) - TRAFFIC_KEYS}
    bad = {k: sorted(v) for k, v in bad.items() if v}
    if bad:
        raise SystemExit(f"perfbench: keys the benchmark does not know: "
                         f"{bad}")


def match_size(config: dict, traffic: dict):
    """(env steps, arenas) of each skill match that the cell plays, from
    its files alone; None where it plays none."""
    skill = config.get("selfplay", {}).get("skill")
    if skill is None or traffic.get("skill_interval") is None:
        return None
    seconds = traffic.get("match_sim_seconds", skill["sim_time"])
    step_seconds = config["env"]["tick_skip"] / 120.0
    return (int(round(seconds / step_seconds)),
            traffic.get("match_arenas", skill["num_arenas"]))


def build(config: dict, traffic: dict, seed: int, device: str,
          checkpoint_folder: str = ""):
    """The trainer of ``config`` under ``traffic``, built through the
    program's own entry points, with every number that the configuration
    file states checked against what was built.  ``checkpoint_folder``:
    where the program saves, every ``traffic['ts_per_save']`` steps."""
    from reinforcement_learning_torch.envs.env import (EnvConfig,
                                                       RocketLeagueEnv)
    from reinforcement_learning_torch.learn.ppo import PPOConfig
    from reinforcement_learning_torch.learn.trainer import (Trainer,
                                                            TrainerConfig)

    check_keys(config, traffic)
    prog, envc = config.get("program", {}), config["env"]
    if "env" in prog:
        env = _resolve(prog["env"])(envc["num_envs"], device=device)
    else:
        env = RocketLeagueEnv(EnvConfig(
            **{k: envc[k] for k in ("num_envs", "team_size", "tick_skip",
                                    "action_delay", "no_touch_timeout",
                                    "max_episode_seconds", "game_mode")},
            device=device))
    ppo = (_resolve(prog["ppo"])(config["scale"]) if "ppo" in prog
           else PPOConfig(**_tuples(config["ppo"])))
    selfplay = None
    if "selfplay" in prog:
        selfplay = _resolve(prog["selfplay"])()
        every = traffic["skill_interval"]
        selfplay = dataclasses.replace(
            selfplay,
            train_against_old_chance=traffic["old_opponent_chance"],
            skill=dataclasses.replace(
                selfplay.skill, enabled=every is not None,
                update_interval=every or selfplay.skill.update_interval,
                num_arenas=traffic.get("match_arenas",
                                       selfplay.skill.num_arenas),
                sim_time=traffic.get("match_sim_seconds",
                                     selfplay.skill.sim_time)))
    step_metrics = (_resolve(prog["step_metrics"])
                    if "step_metrics" in prog else None)
    tc = config["trainer"]
    saves = {k: traffic[k] for k in ("ts_per_save", "checkpoints_to_keep")
             if k in traffic}
    trainer = Trainer(env, ppo, TrainerConfig(
        ts_per_itr=tc["ts_per_itr"],
        standardize_returns=tc["standardize_returns"],
        standardize_obs=tc["standardize_obs"], random_seed=seed % 2 ** 32,
        checkpoint_folder=checkpoint_folder if saves else "", **saves),
        selfplay=selfplay, step_metrics_fn=step_metrics)
    _check_built(config, traffic, trainer)
    return trainer


def _env_differs(env, spec: dict, prefix: str = "") -> dict:
    """What of ``env`` differs from an env of the reference's
    ``env_spec``: (built, file) by key."""
    got = {"team_size": env.config.team_size,
           "tick_skip": env.config.tick_skip,
           "action_delay": env.config.action_delay,
           "no_touch_timeout": env.config.no_touch_timeout,
           "max_episode_seconds": env.config.max_episode_seconds,
           "game_mode": env.config.game_mode,
           "use_mesh": env.params.use_mesh,
           "dynamic_wheel_rays": env.params.dynamic_wheel_rays,
           "obs": type(env.obs_builder).__name__,
           "action_parser": type(env.action_parser).__name__,
           "rewards": [[w.name, w.weight] for w in env.reward_fns]}
    want = dict(spec, rewards=[[r["name"], r["weight"]]
                               for r in spec["rewards"]])
    bad = {prefix + k: (v, want[k]) for k, v in got.items() if want[k] != v}
    if env.portable:
        bad[prefix + "physics"] = ("portable", "kernel")
    return bad


def _check_built(config: dict, traffic: dict, trainer):
    """Raise where the built program differs from the configuration file
    and the cell: the files are what the benchmark claims to run, and what
    the reference rebuilds."""
    from perfbench.reference.env import env_spec
    env = trainer.env
    bad = _env_differs(env, env_spec(config))
    if env.config.num_envs != config["env"]["num_envs"]:
        bad["num_envs"] = (env.config.num_envs, config["env"]["num_envs"])
    if (env.obs_size, env.num_actions) != (config["obs_size"],
                                           config["num_actions"]):
        bad["obs_size, num_actions"] = ((env.obs_size, env.num_actions),
                                        (config["obs_size"],
                                         config["num_actions"]))
    ppo = dataclasses.asdict(trainer.ppo_config)
    bad.update({f"ppo.{k}": (ppo.get(k), v) for k, v in
                _tuples(config["ppo"]).items() if ppo.get(k, v) != v
                or k not in ppo})
    size = match_size(config, traffic)
    tracker = trainer.skill_tracker
    if (size is None) != (tracker is None):
        bad["skill matches"] = (tracker is not None, size is not None)
    elif tracker is not None:
        bad.update(_env_differs(tracker.env, env_spec(config, match=True),
                                "match "))
        got = (tracker.steps_per_run, tracker.env.config.num_envs)
        if got != size:
            bad["match (env steps, arenas)"] = (got, size)
    if bad:
        raise SystemExit("perfbench: the program built differs from its "
                         f"configuration file (built, file): {bad}")


class Probe:
    """The benchmark's wrappers around the calls into the program's
    layers.  Always: every skill match's ratings before and after, its env
    steps and arenas, and each step's goal events.  ``spans``: record
    host-clock spans (``record_function`` annotations too, which a profiler
    sees) and the rows that each model pass takes; the ends of ``collect``
    and ``learn`` wait for the device, so that the two add up to the
    iteration.  ``phase`` (set by the harness) labels each match."""

    def __init__(self, trainer, spans: bool):
        from reinforcement_learning_torch.envs import env as envmod
        self.trainer = trainer
        self.spans = defaultdict(list)
        self.rows = defaultdict(int)
        self.phase = "setup"
        self.in_match = False
        self.matches = []          # every skill match (see ``_match``)
        self.capture = None        # a dict while an iteration is captured
        self.match_capture = None  # a dict while a match step is awaited
        self.count_ops = None      # a counter for the next env step
        self.launches = 0          # the training's kernel launches
        self.launch_inputs = None  # (launch number, inputs) to record
        self._saved = []
        t, env, learner = trainer, trainer.env, trainer.learner
        sync = self.sync = env.device.type == "cuda"
        self._wrap(envmod, "arena_step", self._arena_step)
        self._wrap(env, "post_physics", self._post_physics)
        self._wrap(learner, "update", self._update)
        self._wrap(learner, "loss", self._loss)
        self._wrap(learner, "_step_model", self._step_model)
        self._wrap(learner, "sample_actions", self._sample)
        self._wrap(t, "learn", self._learn)
        tracker = t.skill_tracker
        if tracker is not None:
            self._wrap(tracker, "run_matches", self._match)
            self._wrap(tracker, "_run", self._match_run)
            self._wrap(tracker.env, "step", self._match_step)
            self._wrap(tracker.env, "post_physics", self._post_physics)
        if spans:
            self._wrap(t, "collect", self._span("trainer.collect", sync))
            self._wrap(t, "learn", self._span("trainer.learn", sync))
            self._wrap(env, "step", self._env_step)
            self._wrap(learner, "sample_actions", self._span("ppo.sample"))
            self._wrap(learner, "values", self._rows("values"))
            self._wrap(learner, "loss", self._rows("loss"))

    def _wrap(self, obj, name, make):
        had = name in vars(obj)
        self._saved.append((obj, name, had, vars(obj).get(name)))
        setattr(obj, name, make(getattr(obj, name)))

    def remove(self):
        for obj, name, had, old in reversed(self._saved):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._saved = []

    # -- spans and rows ---------------------------------------------------
    def _span(self, key, sync=False):
        def make(orig):
            def wrapper(*args, **kw):
                if self.in_match and key != "selfplay.match":
                    return orig(*args, **kw)
                with torch.profiler.record_function(key):
                    t0 = time.perf_counter()
                    out = orig(*args, **kw)
                    if sync:
                        torch.cuda.synchronize()
                    self.spans[key].append(time.perf_counter() - t0)
                return out
            return wrapper
        return make

    def _rows(self, key):
        def make(orig):
            def wrapper(obs_or_batch, *args, **kw):
                obs = (obs_or_batch["obs"] if isinstance(obs_or_batch, dict)
                       else obs_or_batch)
                self.rows[key] += obs.shape[0]
                return orig(obs_or_batch, *args, **kw)
            return wrapper
        return make

    def _env_step(self, orig):
        timed = self._span("env.step")(orig)

        def wrapper(*args, **kw):
            counter, self.count_ops = self.count_ops, None
            if counter is None:
                return timed(*args, **kw)
            with counter:
                return orig(*args, **kw)
        return wrapper

    # -- skill matches ------------------------------------------------------
    def _match(self, orig):
        timed = self._span("selfplay.match", self.sync)(orig)

        def wrapper(learner, bank, rng):
            before = bank.ratings.clone()
            match = dict(phase=self.phase, steps=0, arenas=None, events=[],
                         new_team=None, before=before,
                         inc=self.trainer.skill_tracker.config.rating_inc)
            self.matches.append(match)
            self.in_match = True
            try:
                out = timed(learner, bank, rng)
            finally:
                self.in_match = False
            match.update(after=bank.ratings.clone(),
                         last=(bank.next_slot - 1) % bank.ratings.shape[0],
                         idx=out[2].get("opponent_idx"))
            want = self.match_capture
            if want is not None and "physics" in want:
                match["capture"], self.match_capture = want, None
            return out
        return wrapper

    def _match_run(self, orig):
        def wrapper(learner, old_params, env_states, new_team, seed):
            self.matches[-1]["new_team"] = int(new_team)
            return orig(learner, old_params, env_states, new_team, seed)
        return wrapper

    def _match_step(self, orig):
        def wrapper(state, action_idx):
            match = self.matches[-1]
            state, out = orig(state, action_idx)
            match["steps"] += 1
            match["arenas"] = action_idx.shape[0]
            # a goal's event with the y of the ball it was read from; NaN
            # where no goal was scored
            match["events"].append(torch.where(
                out.goal_scored, state.prev_arena.ball.pos[:, 1],
                torch.nan))
            return state, out
        return wrapper

    def _match_step_taken(self) -> bool:
        """Whether the match step under way is the one awaited."""
        want = self.match_capture
        return (want is not None and self.in_match
                and self.matches[-1]["steps"] + 1 == want["step"])

    def _sample(self, orig):
        def wrapper(obs, *args, **kw):
            if self.in_match:
                self.rows["match_sample"] += obs.shape[0]
            else:
                self.rows["sample"] += obs.shape[0]
            actions, logp = orig(obs, *args, **kw)
            if self._match_step_taken():
                params = kw.get("params")
                if params is None:   # the learner's own
                    params = dict(self.trainer.learner.named_parameters())
                else:
                    params = {f"{group}.{k}": v
                              for group, leaves in params.items()
                              if leaves is not None
                              for k, v in leaves.items()}
                self.match_capture.setdefault("samples", []).append(dict(
                    obs=to_plain(obs), mask=to_plain(args[0]),
                    action=to_plain(actions), logp=to_plain(logp),
                    params=to_plain(params)))
            return actions, logp
        return wrapper

    # -- what is captured -------------------------------------------------
    def _arena_step(self, orig):
        def wrapper(phys, controls, respawn_idx, *args, **kw):
            out = orig(phys, controls, respawn_idx, *args, **kw)
            record = None
            if self.in_match:
                if self._match_step_taken():
                    record = self.match_capture
            else:
                self.launches += 1
                cap = self.capture
                if cap is not None and self.launches == cap["physics_step"]:
                    record = cap
                if (self.launch_inputs is not None
                        and self.launches == self.launch_inputs[0]):
                    self.launch_inputs = (self.launch_inputs[0], dict(
                        phys=phys, controls=controls,
                        respawn_idx=respawn_idx, out=out))
            if record is not None:
                record["physics"] = dict(
                    phys=to_plain(phys), controls=to_plain(controls),
                    respawn_idx=to_plain(respawn_idx), out=to_plain(out))
            return out
        return wrapper

    def _post_physics(self, orig):
        env = orig.__self__

        def wrapper(state, phys, controls):
            if self.in_match:
                record = (self.match_capture if self._match_step_taken()
                          else None)
            else:
                cap = self.capture
                record = (cap if cap is not None
                          and self.launches == cap["physics_step"] else None)
            gen = env.generator.get_state() if record is not None else None
            next_state, out = orig(state, phys, controls)
            if record is not None:
                record["post_physics"] = dict(
                    state=to_plain(state), phys=to_plain(phys),
                    controls=to_plain(controls), generator=gen,
                    next_state=to_plain(next_state), out=to_plain(out))
            return next_state, out
        return wrapper

    def _learn(self, orig):
        def wrapper(state, traj, perms=None, weight=None):
            cap = self.capture
            if cap is None:
                return orig(state, traj, perms=perms, weight=weight)
            it = dict(traj={k: to_plain(traj[k]) for k in (
                "obs", "mask", "action", "old_logp", "reward", "terminal",
                "final_obs")}, weight=to_plain(weight), losses=[])
            if cap["from_program"]:
                learner = self.trainer.learner
                it["start"] = dict(
                    params=to_plain(dict(learner.named_parameters())),
                    optimizers={name: {
                        k: to_plain(learner.optimizers[name].state[p])
                        for k, p in model.named_parameters()}
                        for name, (model, _) in learner._models().items()},
                    return_stat=to_plain(state.return_stat))
            cap["iterations"].append(it)
            state, metrics = orig(state, traj, perms=perms, weight=weight)
            it["losses"] = [float(x) for x in it["losses"]]
            it["return_stat"] = to_plain(state.return_stat)
            return state, metrics
        return wrapper

    def _update(self, orig):
        def wrapper(data, generator=None, **kw):
            cap = self.capture
            if cap is not None:
                it = cap["iterations"][-1]
                it["generator"] = generator.get_state()
                it["advantage"] = to_plain(data["advantage"])
                it["target_value"] = to_plain(data["target_value"])
            return orig(data, generator=generator, **kw)
        return wrapper

    def _loss(self, orig):
        def wrapper(batch, *args, **kw):
            total, aux = orig(batch, *args, **kw)
            if self.capture is not None and not self.in_match:
                self.capture["iterations"][-1]["losses"].append(
                    total.detach())
            return total, aux
        return wrapper

    def _step_model(self, orig):
        def wrapper(name):
            orig(name)
            cap = self.capture
            if cap is not None and name not in cap["first_grad"]:
                learner = self.trainer.learner
                opt = learner.optimizers[name]
                model = learner._models()[name][0]
                b1 = opt.param_groups[0]["betas"][0]
                # a step that left no state records no gradient
                cap["first_grad"][name] = {
                    k: to_plain(opt.state[p]["exp_avg"] / (1 - b1))
                    for k, p in model.named_parameters()
                    if "exp_avg" in opt.state[p]}
        return wrapper

    @contextlib.contextmanager
    def capturing(self, physics_step: int, from_program: bool = False):
        """Capture the iterations run inside; ``physics_step``: the
        training launch (counted from 1) whose env step is recorded, or 0
        for none; ``from_program``: also each iteration's starting
        parameters, optimiser states and return statistic (the reference
        follows it from there)."""
        self.capture = dict(iterations=[], first_grad={},
                            physics_step=physics_step,
                            from_program=from_program)
        try:
            yield self.capture
        finally:
            cap, self.capture = self.capture, None
            cap["launches"] = self.launches
            cap["params_after"] = to_plain(dict(
                self.trainer.learner.named_parameters()))
