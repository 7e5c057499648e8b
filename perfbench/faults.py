"""Faults planted under the timed path, for the readings that set the
limits (``perfbench/readings.py``) and for the tests that see ``correct``
come out false (``perfbench/tests/``).  The benchmark's own runs never
plant one.

Each fault is a context manager that patches the program where the fault
would arise and restores it on exit; apply it before the trainer and its
probes are built.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged_state():
    """The update's step returns the parameters and optimiser states
    unchanged."""
    from reinforcement_learning_torch.learn.ppo import PPOLearner
    with _patched(PPOLearner, "_step_model", lambda self, name: None):
        yield


@contextlib.contextmanager
def half_batch():
    """Each minibatch's loss over its first half of the rows, the mean
    taken over that half."""
    from reinforcement_learning_torch.learn.ppo import PPOLearner
    loss = PPOLearner.loss

    def half(self, batch, guiding=None, denom=None):
        n = batch["obs"].shape[0] // 2
        return loss(self, {k: v[:n] for k, v in batch.items()}, guiding,
                    None)
    with _patched(PPOLearner, "loss", half):
        yield


@contextlib.contextmanager
def physics_unchanged():
    """The kernel's step returns the state it was given."""
    from reinforcement_learning_torch.envs import env as envmod
    with _patched(envmod, "arena_step", lambda phys, *a, **k: phys):
        yield


@contextlib.contextmanager
def physics_altered():
    """The kernel's next state with every ball moved 1 uu along x."""
    from reinforcement_learning_torch.envs import env as envmod
    step = envmod.arena_step

    def altered(*args, **kw):
        out = step(*args, **kw)
        out.arena.ball.pos = out.arena.ball.pos + torch.tensor(
            [1.0, 0.0, 0.0], device=out.arena.ball.pos.device)
        return out
    with _patched(envmod, "arena_step", altered):
        yield


@contextlib.contextmanager
def reward_altered():
    """The env's rewards raised by 1e-3 where they are produced."""
    from reinforcement_learning_torch.envs.env import RocketLeagueEnv
    post = RocketLeagueEnv.post_physics

    def altered(self, state, phys, controls):
        next_state, out = post(self, state, phys, controls)
        if out.reward is not None:   # a skill match's env has no rewards
            out.reward = out.reward + 1e-3
        return next_state, out
    with _patched(RocketLeagueEnv, "post_physics", altered):
        yield


@contextlib.contextmanager
def logp_altered():
    """The log-probabilities of the sampled actions lowered by 0.05 where
    inference produces them."""
    from reinforcement_learning_torch.learn.ppo import PPOLearner
    sample = PPOLearner.sample_actions

    def altered(self, *args, **kw):
        actions, logp = sample(self, *args, **kw)
        return actions, logp - 0.05
    with _patched(PPOLearner, "sample_actions", altered):
        yield


@contextlib.contextmanager
def values_bf16():
    """The critic's value pass in bf16 where the configuration states
    fp32."""
    from reinforcement_learning_torch.learn.ppo import PPOLearner
    values = PPOLearner.values

    def low(self, obs, half=None):
        return values(self, obs, half=True)
    with _patched(PPOLearner, "values", low):
        yield


@contextlib.contextmanager
def return_stat_unchanged():
    """The return statistic's update returns it unchanged."""
    from reinforcement_learning_torch.learn import trainer
    with _patched(trainer.welford, "update_batch",
                  lambda state, x, all_sum=None: state):
        yield


@contextlib.contextmanager
def elo_altered():
    """Each skill match writes the opponent's rating 1 point too high."""
    from reinforcement_learning_torch.learn.selfplay import SkillTracker
    run = SkillTracker.run_matches

    def altered(self, learner, bank, rng):
        bank, cur, info = run(self, learner, bank, rng)
        if "opponent_idx" in info:
            bank.ratings[info["opponent_idx"]] += 1.0
        return bank, cur, info
    with _patched(SkillTracker, "run_matches", altered):
        yield


@contextlib.contextmanager
def match_shortened():
    """Each skill match runs half of its env steps."""
    from reinforcement_learning_torch.learn.selfplay import SkillTracker
    run = SkillTracker._run

    def short(self, *args, **kw):
        full = self.steps_per_run
        self.steps_per_run = max(full // 2, 1)
        try:
            return run(self, *args, **kw)
        finally:
            self.steps_per_run = full
    with _patched(SkillTracker, "_run", short):
        yield


def _faulty_rank() -> bool:
    """Whether this process is the data-parallel rank a rank's fault is
    planted on (rank 1)."""
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_rank() == FAULTY_RANK


FAULTY_RANK = 1


@contextlib.contextmanager
def rank_skips_allreduce():
    """One rank takes its part in the gradients' all-reduce but steps its
    own local gradient."""
    from reinforcement_learning_torch.learn import ppo
    all_sum = ppo._all_sum_grads

    def local(params, shard):
        if not _faulty_rank():
            return all_sum(params, shard)
        shard.all_sum(torch.cat([p.grad.reshape(-1) for p in params]))
    with _patched(ppo, "_all_sum_grads", local):
        yield


@contextlib.contextmanager
def rank_keeps_neighbours_block():
    """The last rank keeps the block before its own of every draw made at
    the global width (reset states, respawn indices) and of the first
    state."""
    import torch.distributed as dist

    from reinforcement_learning_torch.envs.shard import EnvShard
    take = EnvShard.take

    def neighbours(self, x):
        if (self.whole or not dist.is_initialized()
                or dist.get_rank() != dist.get_world_size() - 1):
            return take(self, x)
        return x[self.offset - self.local_envs:self.offset]
    with _patched(EnvShard, "take", neighbours):
        yield


def _pad(x, steps: int):
    """Each stacked tensor of ``x`` with fewer than ``steps`` steps padded
    to ``steps`` with its last step."""
    if isinstance(x, dict):
        return {k: _pad(v, steps) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_pad(v, steps) for v in x)
    if x.shape[0] >= steps:
        return x
    return torch.cat([x] + [x[-1:]] * (steps - x.shape[0]))


@contextlib.contextmanager
def rank_short_window():
    """One rank stops each iteration's collection an env step early, its
    last step's rows standing in for the step it left out (also in the
    per-step sums it all-reduces, so that the ranks' collectives still
    pair up)."""
    from reinforcement_learning_torch.learn.trainer import Trainer
    collect, means = Trainer.collect, Trainer._component_means

    def short(self, state, T=None, **kw):
        T = self.steps_per_itr if T is None else T
        if not _faulty_rank() or T < 2:
            return collect(self, state, T, **kw)
        self._fault_steps = T
        try:
            state, traj = collect(self, state, T - 1, **kw)
        finally:
            del self._fault_steps
        return state, _pad(traj, T)

    def padded(self, sums, last):
        steps = getattr(self, "_fault_steps", 0)
        return means(self, _pad(sums, steps), last)
    with _patched(Trainer, "collect", short), \
            _patched(Trainer, "_component_means", padded):
        yield


FAULTS = {f.__name__: f for f in (
    unchanged_state, half_batch, physics_unchanged, physics_altered,
    reward_altered, logp_altered, values_bf16, return_stat_unchanged,
    elo_altered, match_shortened, rank_skips_allreduce, rank_short_window,
    rank_keeps_neighbours_block)}
