"""What the card tests share: the ``card`` fixture, the kernel-against-plain
comparison, the crafted states and the small helpers of their checks.

The card tests are every test marked ``card``: ``tests/test_torch_card_*.py``,
``test_torch_kernel_graph.py``, ``test_torch_env_graph.py``,
``test_torch_kernel_3v3.py`` and the card case of ``test_torch_profile.py``.
They skip without a CUDA card.  On a machine with one, from the root of the
repository::

    python -m pytest tests/test_torch_card_*.py tests/test_torch_kernel_graph.py \\
        tests/test_torch_env_graph.py tests/test_torch_kernel_3v3.py \\
        tests/test_torch_profile.py -m card --noconftest -q

``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine lacks.  ``-k <case>`` runs one case alone: each case seeds its own
generator with ``SEED`` and builds its own state; what several cases of a
file share comes from a module-scoped fixture, or from a session-scoped one
here where cases of two files share it (``bench_run``, ``twin``).  This
module imports torch, the port and ``bench_torch`` only, and is not a test
file.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from bench_torch import BENCH_PPO, bench_trainer
from reinforcement_learning_torch import maths
from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.envs import state_setters, terminals
from reinforcement_learning_torch.envs.env import EnvConfig, RocketLeagueEnv
from reinforcement_learning_torch.examples import (train_1v1, train_2v2,
                                                   train_3v3)
from reinforcement_learning_torch.learn import selfplay as sp
from reinforcement_learning_torch.learn.ppo import (UPDATE_METRICS, PPOConfig,
                                                    _full_fp32_matmul)
from reinforcement_learning_torch.learn.trainer import Trainer, TrainerConfig
from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.ops import ctick
from reinforcement_learning_torch.utils import cuda_graph, tracing

# the main path's shape (bench.py): arenas, cars an arena, env steps an
# iteration
E, CARS, T = 1024, 4, 24
SEED = 0
THRESHOLD_SHARE = 0.001   # arenas (or rows) allowed a flipped flag
PORTABLE_SHARE = 0.02     # arenas or balls allowed off, card vs CPU

# torch's own thread count, before a CPU test file imported with it at 1
THREADS = torch.get_num_threads()

# Timers that a discrete event resets to a constant (a bump, a demo): an
# arena where one of them disagrees beyond its tolerance had the event on
# one side only, and counts with the arenas whose flags differ.
EVENT_TIMERS = ("arena.cars.car_contact_cooldown",
                "arena.cars.demo_respawn_timer")


@pytest.fixture(scope="session")
def card():
    """``"cuda"``, with TF32 off in matmuls and cuDNN and torch's own
    thread count for the CPU references; skips the test where there is no
    CUDA card (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def counter(name: str) -> int:
    """The tracer's counter ``name`` since the last ``tracing.reset()``."""
    return tracing.summary()["counters"].get(name, 0)


def flatten(obj, prefix=""):
    """A dataclass tree's leaves by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def compare(got, want, allowed_arenas, floats_count=False, tolerance=None):
    """Hold ``got`` (the kernel's state, or the card's) to ``want`` (the
    plain step's, or the CPU's) field by field, each float field to its
    ``ops.ctick.TOLERANCES`` entry (``DEFAULT_TOLERANCE`` where it has
    none), or every one to ``tolerance`` (atol, rtol) where given.  Arenas
    where an integer or flag field, or an event timer, differs are
    counted; at most ``allowed_arenas`` may, and their floats are not
    compared.  With ``floats_count`` an arena with a float beyond its
    tolerance counts with them instead of failing.  Returns the worst float
    deviation over the arenas that agree."""
    g, w = flatten(got), flatten(want)
    tols = {} if tolerance is not None else ctick.TOLERANCES
    default = tolerance if tolerance is not None else ctick.DEFAULT_TOLERANCE
    n = w["arena.tick_count"].shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=g["arena.tick_count"].device)
    flips = {}
    for k, a in w.items():
        b = g[k]
        atol, rtol = tols.get(k, default)
        if k in EVENT_TIMERS:
            d = (b - a).abs() > atol + rtol * a.abs()
        elif not a.dtype.is_floating_point:
            d = b != a
        elif floats_count:
            d = ((b - a).abs() > atol + rtol * a.abs()) | ~torch.isfinite(b)
        else:
            continue
        d = d.reshape(n, -1).any(-1)
        if bool(d.any()):
            flips[k] = d.nonzero()[:, 0].tolist()[:8]
        bad |= d
    n_bad = int(bad.sum())
    assert n_bad <= allowed_arenas, (
        f"{n_bad} arenas differ in a flag, an integer or an event timer"
        f"{' or a float beyond tolerance' if floats_count else ''} "
        f"(allowed {allowed_arenas}); first arenas by field: {flips}")
    ok = ~bad
    worst = 0.0
    for k, a in w.items():
        if not a.dtype.is_floating_point:
            continue
        b = g[k]
        atol, rtol = tols.get(k, default)
        dev = (b[ok] - a[ok]).abs()
        off = float(dev.max()) if dev.numel() else 0.0
        assert bool(torch.isfinite(b).all()), f"{k} holds NaN or inf"
        assert not bool((dev > atol + rtol * a[ok].abs()).any()), (
            f"{k} off by {off:.3g} (atol {atol}, rtol {rtol})")
        worst = max(worst, off)
    return worst


def kernel_and_plain(phys, controls, respawn_idx, params, teams):
    """One env step of the kernel and of the plain version from ``phys``.
    Returns (the kernel's next state, ``live``): the plain step's
    ``LiveCandidates``, with its ``SnowContacts`` as ``live.snow`` and its
    next state as ``live.want``."""
    teams = tuple(int(t) for t in teams)
    got = A.arena_step(phys, controls, respawn_idx, params, teams)
    with LiveCandidates() as live, SnowContacts() as live.snow:
        live.want = ctick.arena_step_reference(
            phys, controls, respawn_idx, A._consts(params, teams))
    return got, live


def kernel_agrees_at(env, phys, actions, gen, allowed=1):
    """The kernel against the plain version on ``phys`` stepped with
    ``actions`` and respawn draws from ``gen``; returns the worst float
    deviation."""
    got, live = kernel_and_plain(phys, env.action_parser.parse(actions),
                                 respawn_draws(gen, *actions.shape),
                                 env.params, env.teams_np)
    return compare(got, live.want, allowed)


def sampled_actions(trainer, state, gen):
    """(E, P) actions the learner samples on ``state``'s obs."""
    n, p = state.obs.shape[:2]
    return trainer.learner.sample_actions(
        state.obs.reshape(n * p, -1), state.masks.reshape(n * p, -1),
        generator=gen)[0].reshape(n, p)


def collect_at_bench_width(env, record=False) -> dict:
    """``Trainer.collect`` of ``T`` env steps on ``env`` with a learner of
    the bench widths, after a warm-up collection of as many, the kernel's
    launches counted over the second.  Returns the trainer, the end state,
    the trajectory and the launches; with ``record`` also the ball and car
    positions and rotations of every state the warm-up stepped from
    (``positions``)."""
    trainer = Trainer(env, PPOConfig(**BENCH_PPO),
                      TrainerConfig(ts_per_itr=100_000, random_seed=SEED))
    state = trainer.init(SEED)
    seen = []
    if record:
        step = env.step

        def recording(st, act):
            seen.append((st.phys.ball.pos.clone(), st.phys.cars.pos.clone(),
                         st.phys.cars.rot.clone()))
            return step(st, act)
        env.step = recording
    state, _ = trainer.collect(state, T)
    if record:
        del env.step
    tracing.reset()
    state, traj = trainer.collect(state, T)
    out = {"trainer": trainer, "state": state, "traj": traj,
           "launches": counter("kernel.launches")}
    if record:
        out["positions"] = [torch.cat(x) for x in zip(*seen)]
    return out


def check_traj(env, traj, steps):
    """Every trajectory entry of its shape and finite; every sampled action
    legal; every log-probability at most 0."""
    n, p = env.config.num_envs, env.config.cars_per_arena
    shapes = dict(obs=(steps, n, p, env.obs_size), mask=(steps, n, p, 90),
                  action=(steps, n, p), old_logp=(steps, n, p),
                  reward=(steps, n, p), terminal=(steps, n),
                  final_obs=(steps, n, p, env.obs_size), goal=(steps, n),
                  touch=(steps, n, p))
    for k, shp in shapes.items():
        v = traj[k]
        assert tuple(v.shape) == shp, k
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all()), f"traj[{k!r}] not finite"
    chosen = torch.gather(traj["mask"], -1, traj["action"][..., None])
    assert bool(chosen.all()), "an action outside its mask was sampled"
    assert bool((traj["old_logp"] <= 0).all()), "log-probabilities above 0"


def check_metrics(metrics, before, after):
    """Every metric finite, the JAX trainer's metric keys present, every
    parameter of ``after`` changed since ``before``."""
    vals = {k: float(v) for k, v in metrics.items()}
    assert [k for k, v in vals.items() if not math.isfinite(v)] == []
    want = set(UPDATE_METRICS) | {
        "reward_mean", "goal_rate", "touch_rate", "episode_terminals",
        "return_std", "reward_clip_portion", "value_mean"}
    assert want <= set(vals), sorted(want - set(vals))
    same = [i for i, (p, q) in enumerate(zip(after, before))
            if bool((p == q).all())]
    assert same == [], f"parameters {same} unchanged by the update"


def parameters(learner) -> list:
    return [p.detach().clone() for p in learner.parameters()]


@pytest.fixture(scope="session")
def bench_run(card):
    """The main path at bench.py's shape: a warm-up iteration, 3 with the
    kernel's launches counted, then one more split into collect, prepare
    and update.  Returns the launches and last metrics of the 3, the
    parameters before the warm-up and after the 3, and the learner with the
    obs rows and masks of the state the split iteration ends in."""
    trainer = bench_trainer(E, "soccar", SEED)
    before = parameters(trainer.learner)
    state, _ = trainer.train_iteration(trainer.init(SEED))
    tracing.reset()
    for _ in range(3):
        state, metrics = trainer.train_iteration(state)
    run = {"trainer": trainer, "launches": counter("kernel.launches"),
           "metrics": metrics, "before": before,
           "after": parameters(trainer.learner)}
    state, traj = trainer.collect(state)
    state, data, _ = trainer.prepare(state, traj)
    trainer.learner.update(data, generator=trainer.generator)
    run.update(learner=trainer.learner,
               obs=state.obs.reshape(-1, state.obs.shape[-1]),
               masks=state.masks.reshape(-1, state.masks.shape[-1]))
    return run


@pytest.fixture(scope="session")
def twin(card, tmp_path_factory):
    """The train_2v2 twin's trainer after a warm-up and 3 iterations, skill
    matches every iteration, the second against an old version for
    certain, with what the tests check recorded: each match's ratings
    against the ELO rule, the second iteration's row weights, the
    launches.  Then its checkpoint, saved, and the obs rows, masks and the
    saved learner's own fp32 logits of two more env steps."""
    folder = str(tmp_path_factory.mktemp("train_2v2"))
    games = train_2v2.NUM_GAMES
    scale = train_2v2.auto_scale(games)
    ppo = train_2v2.ppo_config(scale)
    spc = train_2v2.selfplay_config()
    spc = dataclasses.replace(spc, skill=dataclasses.replace(
        spc.skill, update_interval=1))

    def make_trainer():
        return Trainer(train_2v2.make_env(games, device=card), ppo,
                       train_2v2.trainer_config(folder), selfplay=spc,
                       step_metrics_fn=train_2v2.step_metrics)
    trainer = make_trainer()
    tracker = trainer.skill_tracker
    run_matches, learn = tracker.run_matches, trainer.learn
    rec = {"matches": [], "weights": [], "scale": scale, "ppo": ppo,
           "make_trainer": make_trainer, "trainer": trainer}

    def checked_matches(learner, bank, rng):
        # the ELO rule for the goals counted, from the ratings before
        before = bank.ratings.clone()
        c = float(sp.current_rating(bank))
        last = (bank.next_slot - 1) % before.shape[0]
        out = run_matches(learner, bank, rng)
        _, cur, info = out
        idx = info["opponent_idx"]
        o = float(before[idx])
        for _ in range(info["new_goals"]):
            c, o = sp.elo_update(c, o, spc.skill.rating_inc)
        for _ in range(info["old_goals"]):
            o, c = sp.elo_update(o, c, spc.skill.rating_inc)
        want = before.clone()
        want[idx] = o
        want[last] = c
        rec["matches"].append((cur == c and torch.equal(bank.ratings, want),
                               info))
        return out
    tracker.run_matches = checked_matches

    def spy_learn(state, traj, perms=None, weight=None):
        rec["weights"].append((weight, traj["action"].shape))
        return learn(state, traj, perms=perms, weight=weight)
    trainer.learn = spy_learn

    # the warm-up snapshots version 0 before its update
    rec["first"] = parameters(trainer.learner.policy)
    state, _ = trainer.train_iteration(trainer.init_or_resume())
    rec["bank_count"] = trainer.bank.count
    rec["version0"] = sp.get_version(trainer.bank, 0)["policy"]
    rec["before"] = parameters(trainer.learner)
    warm_matches = len(rec["matches"])
    tracing.reset()
    for i in range(3):
        trainer.selfplay = dataclasses.replace(
            spc, train_against_old_chance=1.0) if i == 1 else spc
        rec["weights"].clear()
        state, metrics = trainer.train_iteration(state)
        extra = dict(trainer.last_selfplay_metrics)
        if i == 1:
            rec["old"] = extra.get("trained_against_old"), rec["weights"][-1]
    rec.update(launches=counter("kernel.launches"), state=state,
               metrics={**metrics, **extra},
               timed_matches=len(rec["matches"]) - warm_matches)
    # the checkpoint, and the saved learner's forward on two more env steps
    rec["checkpoint"] = trainer.save(state)
    _, traj = trainer.collect(state, 2)
    rows = traj["obs"].reshape(-1, traj["obs"].shape[-1])
    with torch.no_grad(), _full_fp32_matmul():
        rec["logits"] = trainer.learner.policy(
            trainer.learner.shared_head(rows))
    rec.update(obs=rows,
               masks=traj["mask"].reshape(-1, traj["mask"].shape[-1]),
               params=trainer.learner.param_counts()["total"])
    return rec


# ---------------------------------------------------------------------------
# the envs the programs step, with auto-resets forced (the graph tests),
# and bit-equal trees

NO_TOUCH_STEPS = 12     # the forced auto-reset: 0.8 s without a touch


def short_timeout(env, *others):
    """``env`` with its no-touch timeout cut to ``NO_TOUCH_STEPS`` env
    steps, beside its other terminal conditions ``others``."""
    step_s = env.config.step_seconds
    env.terminal_fn = terminals.combine_conditions(
        [terminals.no_touch_condition(NO_TOUCH_STEPS * step_s, step_s)]
        + list(others))
    return env


def goal_and_timeout(env):
    return (terminals.goal_score_condition(),
            terminals.timeout_condition(env.config.max_episode_seconds,
                                        env.config.step_seconds))


def example_env(device, n=512):
    """train_2v2's env: 2v2, AdvancedObs, the 13-term rewards, the score
    limit."""
    env = train_2v2.make_env(n, device=device)
    return short_timeout(env, terminals.score_limit_condition(3),
                         goal_and_timeout(env)[1])


def three_v_three_env(device, n=512):
    """train_3v3's env: six cars an arena, AdvancedObs 225, the 13-term
    rewards at three a team, the score limit."""
    env = train_3v3.make_env(n, device=device)
    return short_timeout(env, terminals.score_limit_condition(3),
                         goal_and_timeout(env)[1])


def bench_env(device, n=1024):
    """The main path's env at bench shape: the default rewards."""
    env = RocketLeagueEnv(EnvConfig(num_envs=n, team_size=2, device=device))
    return short_timeout(env, *goal_and_timeout(env))


def match_env(device, n=16, team_size=2):
    """A skill match's env (``selfplay.SkillTracker``): no rewards, the
    goal terminal, the kickoff fuzzed by 0.1."""
    env = RocketLeagueEnv(
        EnvConfig(num_envs=n, team_size=team_size, max_episode_seconds=1e9,
                  no_touch_timeout=1e9, device=device),
        reward_fns=[], state_setter=state_setters.kickoff_state(fuzz=0.1))
    return short_timeout(env, terminals.goal_score_condition())


def one_v_one_env(device, n=256):
    env = train_1v1.make_env(n, device=device)
    return short_timeout(env, *goal_and_timeout(env))


def heatseeker_env(device, n=2):
    env = RocketLeagueEnv(EnvConfig(num_envs=n, team_size=2,
                                    game_mode="heatseeker", device=device))
    return short_timeout(env, *goal_and_timeout(env))


def staggered(state):
    """Each arena starts its no-touch count at another step, so that some
    arenas reset on most steps and the others do not."""
    n = state.steps_since_touch.shape[0]
    start = torch.arange(n, device=state.steps_since_touch.device)
    return dataclasses.replace(
        state, steps_since_touch=(start % NO_TOUCH_STEPS).to(torch.int32))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    """Equal trees, every tensor leaf equal bit for bit."""
    lg, lw = [], []
    assert cuda_graph.flatten(got, lg) == cuda_graph.flatten(want, lw)
    for a, b in zip(lg, lw):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert torch.equal(_bits(a), _bits(b))


def copy_tree(tree):
    """A copy of ``tree`` with every tensor leaf cloned."""
    leaves = []
    spec = cuda_graph.flatten(tree, leaves)
    return cuda_graph.unflatten(spec, iter([t.clone() for t in leaves]))


# ---------------------------------------------------------------------------
# crafted states

def random_controls(gen, n=E, cars=CARS):
    """Analog controls uniform in [-1, 1], buttons on or off."""
    dev = gen.device
    analog = torch.rand(n, cars, 5, generator=gen, device=dev) * 2 - 1
    buttons = (torch.rand(n, cars, 3, generator=gen, device=dev)
               > 0.5).float()
    return torch.cat([analog, buttons], -1)


def respawn_draws(gen, n=E, cars=CARS):
    return torch.randint(0, 4, (n, cars), generator=gen, device=gen.device,
                         dtype=torch.int32)


def played(env, seed, gen, steps=6):
    """``env``'s state ``steps`` random env steps after its kickoff."""
    state, _, _ = env.reset(seed)
    n, p = env.config.num_envs, env.config.cars_per_arena
    for _ in range(steps):
        act = torch.randint(0, env.num_actions, (n, p), generator=gen,
                            device=gen.device)
        state, _ = env.step(state, act)
    return state


def stack3(x, y, z):
    return torch.stack([x, y, z], -1)


class States:
    """Crafted kernel-vs-plain states, each a copy of a played state with
    bodies moved by draws from one seeded generator."""

    def __init__(self, gen):
        self.dev, self.gen = gen.device, gen

    def u(self, lo, hi, n=E):
        return lo + (hi - lo) * torch.rand(n, generator=self.gen,
                                           device=self.dev)

    def sign(self):
        return torch.where(self.u(0, 1) > 0.5, 1.0, -1.0)

    def copy(self, phys):
        return tree_map(lambda t: t.clone(), phys)

    def still_ball(self, phys):
        phys = self.copy(phys)
        phys.arena.ball.ang_vel = torch.zeros_like(phys.arena.ball.ang_vel)
        return phys

    # -- plane arena --------------------------------------------------------
    def demo_respawn(self, phys):
        """Cars 0 and 3 demolished, respawning 1-9 ticks into the step."""
        phys = self.copy(phys)
        cars = phys.arena.cars
        demoed = torch.zeros_like(cars.is_demoed)
        demoed[:, 0] = demoed[:, 3] = True
        ticks = torch.randint(1, 10, demoed.shape, generator=self.gen,
                              device=self.dev)
        cars.is_demoed = demoed
        cars.demo_respawn_timer = torch.where(demoed, ticks / 120.0, 0.0)
        return phys

    def car_car(self, phys):
        """Car 0 drives into car 2 and car 3 into car 1, nearly head-on,
        hitboxes a few uu into each other; half the attackers are
        supersonic."""
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u
        for att, vic, y0 in ((0, 2, -1500.0), (3, 1, 1500.0)):
            x0 = u(-2000, 2000)
            ya, yv = u(-0.15, 0.15), torch.pi + u(-0.15, 0.15)
            fast = torch.arange(E, device=self.dev) % 2 == 0
            speed = torch.where(fast, 2250.0, 900.0)
            z = torch.full_like(x0, 17.0)
            cars.pos[:, att] = stack3(x0, torch.full_like(x0, y0), z)
            cars.pos[:, vic] = stack3(x0 + u(138, 144), y0 + u(-20, 20), z)
            cars.vel[:, att] = stack3(speed * torch.cos(ya),
                                      speed * torch.sin(ya), 0 * z)
            cars.vel[:, vic] = stack3(-300 + 0 * z, u(-100, 100), 0 * z)
            cars.rot[:, att] = maths.euler_to_rotmat(ya)
            cars.rot[:, vic] = maths.euler_to_rotmat(yv)
            cars.ang_vel[:, att] = 0.0
            cars.ang_vel[:, vic] = 0.0
            cars.is_supersonic[:, att] = fast
            cars.is_demoed[:, att] = cars.is_demoed[:, vic] = False
            cars.is_on_ground[:, att] = cars.is_on_ground[:, vic] = True
        return phys

    def car_ball(self, phys):
        """Car 0 drives into the resting ball from about 150 uu behind it,
        a little off centre; the ball anywhere on the field."""
        phys = self.copy(phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = self.u
        bx, by = u(-3000, 3000), u(-4000, 4000)
        ball.pos = stack3(bx, by, torch.full_like(bx, 93.15))
        ball.vel = torch.zeros_like(ball.vel)
        ball.ang_vel = torch.zeros_like(ball.ang_vel)
        cars.pos[:, 0] = stack3(bx - 150 + u(-10, 20), by + u(-30, 30),
                                torch.full_like(bx, 17.0))
        cars.vel[:, 0] = stack3(u(800, 1600), 0 * bx, 0 * bx)
        cars.rot[:, 0] = torch.eye(3, device=self.dev)
        cars.ang_vel[:, 0] = 0.0
        cars.is_demoed[:, 0] = False
        return phys

    def walls(self, phys):
        """The ball flies into a side wall (even arenas) or a back wall,
        into the goal where it meets the opening; car 1 drives into a side
        wall and car 2 falls onto the floor from above."""
        phys = self.copy(phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = self.u
        sign = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        side = torch.arange(E, device=self.dev) % 2 == 0
        near = sign * (4000.0 - u(0, 40))
        across = u(-1500, 1500)
        ball.pos = stack3(torch.where(side, near, across),
                          torch.where(side, u(-3000, 3000), near * 1.25),
                          u(93.15, 1200))
        fast = sign * u(500, 2000)
        ball.vel = stack3(torch.where(side, fast, u(-300, 300)),
                          torch.where(side, u(-300, 300), fast),
                          u(-300, 300))
        ball.ang_vel = stack3(u(-2, 2), u(-2, 2), u(-2, 2))
        wall_x = -sign * (4096.0 - 80.0 - u(0, 30))
        cars.pos[:, 1] = stack3(wall_x, u(-3000, 3000),
                                torch.full_like(wall_x, 17.0))
        cars.vel[:, 1] = stack3(-sign * u(500, 1500), u(-200, 200),
                                0 * wall_x)
        cars.rot[:, 1] = maths.euler_to_rotmat(
            torch.where(sign > 0, torch.pi, 0.0) + u(-0.3, 0.3))
        cars.ang_vel[:, 1] = 0.0
        cars.pos[:, 2, 2] = u(30, 120)
        cars.vel[:, 2, 2] = u(-600, -100)
        cars.is_demoed[:, 1] = cars.is_demoed[:, 2] = False
        return phys

    # -- full fidelity ------------------------------------------------------
    def fillet_ball(self, phys):
        """The ball flies into the floor fillet of a side wall (tests/
        test_ctick.py:258, moved a step closer): it must bounce up."""
        phys = self.still_ball(phys)
        ball = phys.arena.ball
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        ball.pos = stack3(sx * u(3960, 3980), u(-3000, 3000), u(120, 130))
        ball.vel = stack3(sx * u(800, 1000), u(-100, 100), u(-350, -250))
        return phys

    def wall_drive(self, phys):
        """Car 1 drives up a back wall on its wheels (y = +-5103, beside
        the goal, 450-900 uu up, facing up the wall), throttle on."""
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        z = torch.zeros_like(sy)
        cars.pos[:, 1] = stack3(sx * u(1300, 2500), sy * 5103.0,
                                u(450, 900))
        cars.vel[:, 1] = stack3(u(-200, 200), z, u(200, 600))
        cars.ang_vel[:, 1] = 0.0
        # columns forward, right, up: forward up the wall, up = -y on the
        # y+ wall and +y on the y- wall
        cars.rot[:, 1] = torch.stack([stack3(z, -sy, z), stack3(z, z, -sy),
                                      stack3(z + 1.0, z, z)], -2)
        cars.is_demoed[:, 1] = False
        return phys

    def box_wall(self, phys, half_width):
        """Car 2 flies side first into a back wall beside the goal, its
        hitbox (``half_width`` to either side) 5-25 uu from the wall at
        1000-1500 uu/s, with no world contact normal recorded yet."""
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        z = torch.zeros_like(sy)
        cars.pos[:, 2] = stack3(sx * u(1300, 2500),
                                sy * (5120.0 - half_width - u(5, 25)),
                                u(300, 1000))
        cars.vel[:, 2] = stack3(z, sy * u(1000, 1500), z)
        cars.ang_vel[:, 2] = 0.0
        cars.rot[:, 2] = torch.eye(3, device=self.dev)
        cars.world_contact_normal[:, 2] = 0.0
        cars.is_demoed[:, 2] = False
        return phys

    def corner_ball(self, phys):
        """The ball flies fast and low into a corner where a side wall
        meets a corner wall, at the seam of their floor fillets, where the
        ball sees more than 8 live facet candidates."""
        phys = self.still_ball(phys)
        ball = phys.arena.ball
        u = self.u
        sx = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        ball.pos = stack3(sx * u(3920, 3960), sy * u(3830, 3900),
                          u(100, 140))
        ball.vel = stack3(sx * u(1500, 2500), sy * u(1500, 2500),
                          u(-600, -300))
        return phys

    def goal_mouth(self, phys):
        """The ball flies into the goal: onto the back net (even arenas)
        or into the crossbar (odd), at both ends."""
        phys = self.still_ball(phys)
        ball = phys.arena.ball
        u = self.u
        sy = torch.where(u(0, 1) > 0.5, 1.0, -1.0)
        net = torch.arange(E, device=self.dev) % 2 == 0
        ball.pos = stack3(torch.where(net, u(-700, 700), u(-600, 600)),
                          sy * torch.where(net, u(5830, 5860),
                                           u(5040, 5070)),
                          torch.where(net, u(150, 500), u(690, 720)))
        ball.vel = stack3(u(-50, 50), sy * u(1000, 1500), u(-100, 0))
        return phys

    def car_on_ball(self, phys):
        """Car 0 dropped onto the resting ball (tests/test_ctick.py:305):
        its wheel rays stand on the ball."""
        phys = self.still_ball(phys)
        cars, ball = phys.arena.cars, phys.arena.ball
        u = self.u
        bx, by = u(-3000, 3000), u(-4000, 4000)
        ball.pos = stack3(bx, by, torch.full_like(bx, 93.15))
        ball.vel = torch.zeros_like(ball.vel)
        # the rear wheels' rays reach the ball's top from 195-198 uu
        cars.pos[:, 0] = stack3(bx + u(-4, 4), by + u(-4, 4), u(195, 198))
        cars.vel[:, 0] = 0.0
        cars.ang_vel[:, 0] = 0.0
        cars.rot[:, 0] = torch.eye(3, device=self.dev)
        cars.is_demoed[:, 0] = False
        return phys

    def car_on_car(self, phys):
        """Car 1 dropped onto car 0's roof, 70-80 uu up: its wheel rays
        reach car 0's box (the roof at 55.8 uu) but not the floor.  Car 1
        is pitched and rolled by 3-7 degrees: two level boxes tie the
        separating-axis test between their up axes, and the last ulp then
        picks the reference face."""
        phys = self.copy(phys)
        cars = phys.arena.cars
        u = self.u

        def tilt():
            return torch.where(u(0, 1) > 0.5, 1.0, -1.0) * u(0.05, 0.12)
        x0, y0, yaw = u(-3000, 3000), u(-4000, 4000), u(-3, 3)
        cars.pos[:, 0] = stack3(x0, y0, torch.full_like(x0, 17.0))
        cars.pos[:, 1] = stack3(x0 + u(-8, 8), y0 + u(-8, 8), u(70, 80))
        cars.rot[:, 0] = maths.euler_to_rotmat(yaw)
        cars.rot[:, 1] = maths.euler_to_rotmat(yaw + u(-0.3, 0.3), tilt(),
                                               tilt())
        for c in (0, 1):
            cars.vel[:, c] = 0.0
            cars.ang_vel[:, c] = 0.0
            cars.is_demoed[:, c] = False
        return phys

    # -- game modes ---------------------------------------------------------
    def hs_flight(self, phys):
        """The heatseeker ball in flight 800-1500 uu up, seeking either
        goal at up to 1500 uu/s, its last hit 0-3 s ago."""
        phys = self.still_ball(phys)
        ball, u = phys.arena.ball, self.u
        ball.pos = stack3(u(-2500, 2500), u(-3000, 3000), u(800, 1500))
        ball.vel = stack3(u(-1500, 1500), u(-1500, 1500), u(-300, 300))
        ball.hs_y_target_dir = self.sign()
        ball.hs_target_speed = u(2900, 4500)
        ball.hs_time_since_hit = u(0, 3)
        return phys

    def hs_touch(self, phys):
        """Car 0 (blue) and car 2 (orange) drive at 1100-1300 uu/s into
        the resting heatseeker ball from either side, 147-157 uu from its
        centre, so that both first touch it in the step's first tick (a
        seeking ball at rest starts at 30% of its target speed); the ball
        idle or seeking, its last hit 0-2 s ago (within the minimum
        speed-up interval or after it); cars 1 and 3 parked out of the
        way; every car's controls released.  The cars come in 5-20 uu off
        the ball's line and up to 0.1 rad off its axis: on the line, the
        friction direction of the contact is rounding noise (ROADMAP
        Queue 5)."""
        phys = self.still_ball(phys)
        cars, ball, u = phys.arena.cars, phys.arena.ball, self.u
        bx, by = u(-2500, 2500), u(-3000, 3000)
        z = torch.zeros_like(bx)
        ball.pos = stack3(bx, by, z + 93.15)
        ball.vel = torch.zeros_like(ball.vel)
        ball.hs_y_target_dir = torch.floor(u(0, 3)).clamp(max=2) - 1
        ball.hs_target_speed = u(2900, 4500)
        ball.hs_time_since_hit = u(0, 2)
        for c, side in ((0, -1.0), (2, 1.0)):
            yaw = (torch.pi if side > 0 else 0.0) + u(-0.1, 0.1)
            speed = u(1100, 1300)
            cars.pos[:, c] = stack3(bx + side * u(147, 157),
                                    by + self.sign() * u(5, 20), z + 17.0)
            cars.vel[:, c] = stack3(speed * torch.cos(yaw),
                                    speed * torch.sin(yaw), z)
            cars.rot[:, c] = maths.euler_to_rotmat(yaw)
        far = -torch.sign(bx) * 3500.0
        cars.pos[:, 1] = stack3(far, by, z + 17.0)
        cars.pos[:, 3] = stack3(far, by - torch.sign(by) * 800.0, z + 17.0)
        # no jump, flip or control left over from the random steps
        for f in ("is_jumping", "has_jumped", "has_double_jumped",
                  "has_flipped", "is_flipping", "is_auto_flipping",
                  "is_demoed"):
            getattr(cars, f)[:] = False
        for f in ("jump_time", "flip_time", "air_time",
                  "air_time_since_jump", "auto_flip_timer", "ang_vel",
                  "controls", "last_controls"):
            getattr(cars, f)[:] = 0.0
        cars.vel[:, 1] = cars.vel[:, 3] = 0.0
        return phys

    def hs_backwall(self, phys):
        """The heatseeker ball 40-60 uu short of a back wall beside the
        goal (|x| 1300-2600, 300-900 uu up), flying into it at 1500-2500
        uu/s while it seeks that wall's goal."""
        phys = self.still_ball(phys)
        ball, u = phys.arena.ball, self.u
        sy = self.sign()
        ball.pos = stack3(self.sign() * u(1300, 2600),
                          sy * (5120.0 - 91.25 - u(40, 60)), u(300, 900))
        ball.vel = stack3(u(-200, 200), sy * u(1500, 2500), u(-100, 100))
        ball.hs_y_target_dir = sy
        ball.hs_target_speed = u(2000, 4000)
        return phys

    def _puck(self, phys):
        """A copy with the puck tilted up to 0.5 rad and spinning; also
        returns the height at which its rim meets the floor."""
        phys = self.copy(phys)
        ball, u = phys.arena.ball, self.u
        ball.rot = maths.euler_to_rotmat(u(-3, 3), u(-0.5, 0.5),
                                         u(-0.5, 0.5))
        ball.ang_vel = stack3(u(-3, 3), u(-3, 3), u(-3, 3))
        az = ball.rot[:, 2, 2].abs()
        rest = 114.25 * torch.sqrt(1 - az * az) + 31.25 * az
        return phys, rest

    def snow_floor(self, phys):
        """A tumbling snowday puck dropped at 300 uu/s on the floor of the
        midfield from 1-5 uu above it."""
        phys, rest = self._puck(phys)
        u = self.u
        phys.arena.ball.pos = stack3(u(-2500, 2500), u(-3500, 3500),
                                     rest + u(1, 5))
        phys.arena.ball.vel = stack3(u(-500, 500), u(-500, 500),
                                     u(-320, -280))
        return phys

    def snow_wall(self, phys):
        """The tilted, spinning puck slides into a side wall (even arenas)
        or into a corner (odd) at an angle, 1-5 uu above the floor."""
        phys, rest = self._puck(phys)
        u = self.u
        sx, sy = self.sign(), self.sign()
        side = torch.arange(E, device=self.dev) % 2 == 0
        phys.arena.ball.pos = stack3(
            sx * torch.where(side, u(3940, 3960), u(3880, 3895)),
            torch.where(side, u(-2000, 2000), sy * u(3985, 3995)),
            rest + u(1, 5))
        phys.arena.ball.vel = stack3(
            sx * torch.where(side, u(1000, 1400), u(800, 1000)),
            torch.where(side, u(-600, 600), sy * u(800, 1000)), u(-50, 0))
        return phys


def battery_group(scenarios, device):
    """The parity battery's scenarios of one car count as one arena axis,
    as the kernel route launches them (tick_skip 1, action delay 0):
    (the state at tick 0, every tick's controls, the respawn draws, the
    params, the teams)."""
    from reinforcement_learning_torch.physics.step import ArenaParams
    from reinforcement_learning_torch.tools import parity
    n_cars = scenarios[0].n_cars
    params = ArenaParams(num_cars=n_cars, use_mesh=True,
                         dynamic_wheel_rays=True)
    phys = tree_map(lambda *xs: torch.stack(xs), *[
        parity._scenario_phys(sc, params, device) for sc in scenarios])
    controls = torch.as_tensor(np.stack([sc.controls for sc in scenarios],
                                        1), device=device)
    r = torch.zeros((len(scenarios), n_cars), dtype=torch.int32,
                    device=device)
    return phys, controls, r, params, tuple(c.team for c in scenarios[0].cars)


def forward_or_random(env, gen):
    """(E, P) action indices: forward with boost in the even arenas (the
    cars meet at the ball: touches and car-car contacts), random in the
    odd ones."""
    table = env.action_parser.table_np
    forward = int(np.flatnonzero(
        (table[:, 0] == 1) & (table[:, 1] == 0) & (table[:, 2] == 0)
        & (table[:, 4] == 0) & (table[:, 5] == 0) & (table[:, 6] == 1)
        & (table[:, 7] == 0))[0])
    n, p = env.config.num_envs, env.config.cars_per_arena
    idx = torch.randint(0, env.num_actions, (n, p), generator=gen,
                        device=env.device)
    idx[0::2] = forward
    return idx


def head_on_6(phys, gen):
    """``phys`` with each blue car (0-2) driving into an orange one (3-5)
    nearly head-on, hitboxes a few uu into each other, the even arenas'
    drivers supersonic: car-car contacts, bumps and demos in every
    arena."""
    phys = tree_map(lambda t: t.clone(), phys)
    cars = phys.arena.cars
    n, dev = cars.pos.shape[0], cars.pos.device

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    speed = torch.where(torch.arange(n, device=dev) % 2 == 0, 2250.0, 900.0)
    z = torch.full((n,), 17.0, device=dev)
    for att in range(3):
        vic = att + 3
        x0, y0 = u(-2200, -1800) + 1800.0 * att, u(-1500, 1500)
        ya, yv = u(-0.15, 0.15), torch.pi + u(-0.15, 0.15)
        cars.pos[:, att] = stack3(x0, y0, z)
        cars.pos[:, vic] = stack3(x0 + u(138, 144), y0 + u(-20, 20), z)
        cars.vel[:, att] = stack3(speed * torch.cos(ya),
                                  speed * torch.sin(ya), 0 * z)
        cars.vel[:, vic] = stack3(-300 + 0 * z, u(-100, 100), 0 * z)
        cars.rot[:, att] = maths.euler_to_rotmat(ya)
        cars.rot[:, vic] = maths.euler_to_rotmat(yv)
        cars.ang_vel[:, att] = cars.ang_vel[:, vic] = 0.0
        cars.is_supersonic[:, att] = speed > 2200.0
        cars.is_demoed[:, att] = cars.is_demoed[:, vic] = False
        cars.is_on_ground[:, att] = cars.is_on_ground[:, vic] = True
    return phys


class SnowContacts:
    """While open, records per arena whether the plain version's snowday
    puck contact (``ctick._resolve_ball_world_snowday``) touched the floor
    or a wall at any tick."""

    def __enter__(self):
        self.floor = self.wall = None
        self._fn = ctick._resolve_ball_world_snowday

        def spy(*args, **kw):
            out = self._fn(*args, **kw)
            touch, n = out[3], out[4]
            # the mean of the live rows' normals: only the floor's points
            # up, only walls' have a horizontal part
            floor = touch & (n[2] > 0.1)
            wall = touch & (torch.sqrt(n[0] * n[0] + n[1] * n[1]) > 0.1)
            self.floor = floor if self.floor is None else self.floor | floor
            self.wall = wall if self.wall is None else self.wall | wall
            return out
        ctick._resolve_ball_world_snowday = spy
        return self

    def __exit__(self, *exc):
        ctick._resolve_ball_world_snowday = self._fn


class LiveCandidates:
    """While open, records the facet-arena contact candidates that the
    plain version's 4-slot retention (``ctick.keep_diverse4``) sees live:
    per arena, the most at any tick for the ball (``ball``, (E,)) and for
    each car (``cars``, (C, E)); None where no retention ran."""

    def __enter__(self):
        self.ball = self.cars = None
        self._keep = ctick.keep_diverse4

        def spy(d, pays, px, py, pz):
            n = (d < 1e30).sum(0)
            if n.dim() == 1:
                self.ball = n if self.ball is None else torch.maximum(
                    self.ball, n)
            else:
                self.cars = n if self.cars is None else torch.maximum(
                    self.cars, n)
            return self._keep(d, pays, px, py, pz)
        ctick.keep_diverse4 = spy
        return self

    def __exit__(self, *exc):
        ctick.keep_diverse4 = self._keep


# ---------------------------------------------------------------------------
# the card against the CPU for the geometry queries: float32 on both, the
# reductions and products rounding apart in the last bits.  At arena scale
# (coordinates up to 8192 uu, where float32's spacing is 4.9e-4 uu) a
# contact point comes out of a chain of about 8 such roundings, so lengths
# agree to 8 spacings; in bt units (1/50) the box-box chain to 1e-4.  A
# flag may differ in at most THRESHOLD_SHARE of the rows, and only where
# its deciding length is within GEOM_ATOL of the threshold.
GEOM_ATOL = 4e-3     # uu
BB_ATOL = 1e-4       # bt (5e-3 uu), box-box points and depths


def close_where(what, got, want, atol, rows=None):
    """max |got - want| over ``rows`` (all by default), at most ``atol``."""
    d = (got.cpu() - want).abs()
    if rows is not None:
        d = d[rows]
    d = float(d.max()) if d.numel() else 0.0
    assert d <= atol, f"{what}: card vs CPU differ by {d:.3g} (tol {atol})"
    return d


def flags_agree(what, got, want, margin=None):
    """Flags equal in all but THRESHOLD_SHARE of the rows (a row: the
    leading index) and, given ``margin``, only where |margin| <=
    GEOM_ATOL.  Returns the flags both set."""
    got = got.cpu()
    differ = got != want
    bad = (differ & (margin.cpu().abs() > GEOM_ATOL) if margin is not None
           else torch.zeros_like(differ))
    rows = differ.reshape(len(differ), -1).any(-1)
    assert not bool(bad.any()), f"{what}: flags differ beyond the margin"
    assert int(rows.sum()) <= THRESHOLD_SHARE * len(rows) + 1, (
        f"{what}: flags differ card vs CPU in {int(rows.sum())} rows")
    return got & want
