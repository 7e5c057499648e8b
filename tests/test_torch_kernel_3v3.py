"""The kernel's 6-car instantiation (``arena_step_kernel<6>``, Standard
3v3) against the plain PyTorch step (``ops/ctick.py``) on the card.

Marked ``card``: skips without one.  On the card run it with
``python -m pytest tests/test_torch_kernel_3v3.py -q --noconftest`` (this
repository's ``tests/conftest.py`` imports JAX, which the card's machine
lacks).  ``train_3v3``'s env at 64 arenas steps from kickoff, half the
arenas driving straight at the ball with boost and half on random actions
(``chip_smoke.forward_or_random``); at the kickoff, at three played env
steps (ball hits) and on the last with the three pairs of opposing cars
driven into each other (bumps and demos; ``chip_smoke.head_on_6``) the
kernel and the plain step advance the same state, controls and respawn
draws, and every float agrees within ``ops/ctick.py``'s tolerances
(``TOLERANCES``, ``DEFAULT_TOLERANCE`` for the fields it does not list),
with no flag, integer or event timer differing in any arena; the port
counts each launch's arenas x cars x ``tick_skip`` as ``kernel.car_ticks``.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from reinforcement_learning_torch.examples import train_3v3
from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.ops import ctick
from reinforcement_learning_torch.utils import tracing

E, P = 64, 6
STEPS = 48
CHECKED = (0, 24, 36, STEPS - 1)   # the kickoff, then played states


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def differing(got, want) -> dict:
    """Field -> arenas where the kernel's ``got`` differs from the plain
    step's ``want``: a float beyond its tolerance or not finite, or any
    difference in a flag, an integer or an event timer."""
    g = dict(_leaves(got))
    out = {}
    for k, a in _leaves(want):
        b = g[k]
        if a.dtype.is_floating_point:
            atol, rtol = ctick.TOLERANCES.get(k, ctick.DEFAULT_TOLERANCE)
            bad = ((b - a).abs() > atol + rtol * a.abs()) | ~torch.isfinite(b)
        else:
            bad = b != a
        bad = bad.reshape(a.shape[0], -1).any(-1)
        if bad.any():
            out[k] = bad.nonzero()[:, 0].tolist()
    return out


@pytest.mark.card
def test_six_car_kernel_equals_the_plain_step(card):
    # the repository's root, where the test runs on the card
    from chip_smoke import forward_or_random, head_on_6
    env = train_3v3.make_env(E, device=card)
    assert env.config.cars_per_arena == P and not env.portable
    teams = tuple(int(t) for t in env.teams_np)
    consts = A._consts(env.params, teams)
    gen = torch.Generator(device=card).manual_seed(2147483713)
    state, _, _ = env.reset(2147483713)
    tracing.reset()

    def check(phys, controls, step):
        r = torch.randint(0, 4, (E, P), generator=gen, device=card,
                          dtype=torch.int32)
        got = A.arena_step(phys, controls, r, env.params, teams)
        want = ctick.arena_step_reference(phys, controls, r, consts)
        assert differing(got, want) == {}, step
        return want.arena

    touched = 0
    for step in range(STEPS):
        controls = env.action_parser.parse(forward_or_random(env, gen))
        if step in CHECKED:
            arena = check(state.phys, controls, step)
            touched += int(arena.cars.ball_hit_valid.any(-1).sum())
        phys = env.physics_step(state, controls)
        state, _ = env.post_physics(state, phys, controls)
    assert touched > 0                 # the played states had ball hits
    # the played state with the three opposing pairs driven into each
    # other: bumps and demos
    arena = check(head_on_6(state.phys, gen), controls, "head_on")
    assert int((arena.step_bump | arena.step_demo).any(-1).sum()) >= E // 2
    # one launch an env step and one a check, each E x 6 x tick_skip
    # car-ticks
    c = tracing.summary()["counters"]
    tracing.reset()
    assert c["kernel.launches"] == STEPS + len(CHECKED) + 1
    assert c["kernel.car_ticks"] == (c["kernel.launches"] * E * P
                                     * env.config.tick_skip)
