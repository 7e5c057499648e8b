"""The kernel's 6-car instantiation (``arena_step_kernel<6>``, Standard
3v3) against the plain PyTorch step (``ops/ctick.py``) on the card.

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).  ``train_3v3``'s env steps from kickoff, half the arenas driving
straight at the ball with boost and half on random actions
(``torch_card.forward_or_random``): 48 env steps at 64 arenas, and the
example's 512 arenas for 300.  At the kickoff, at played env steps (ball
hits) and on the last with the three pairs of opposing cars driven into
each other (bumps and demos; ``torch_card.head_on_6``) the kernel and the
plain step advance the same state, controls and respawn draws, and every
float agrees within ``ops/ctick.py``'s tolerances (``TOLERANCES``,
``DEFAULT_TOLERANCE`` for the fields it does not list), with no flag,
integer or event timer differing in any arena; one launch an env step and
one a check.  Then 4 env steps of post-physics replayed from its graph
equal the eager path bit for bit on the played state.
"""

from __future__ import annotations

import pytest
import torch

from reinforcement_learning_torch.examples import train_3v3
from reinforcement_learning_torch.utils import tracing
from torch_card import (SEED, assert_same, card, compare, counter,
                        forward_or_random, head_on_6, kernel_and_plain,
                        respawn_draws)

P = 6
# case -> (arenas, env steps, the steps checked, reset seed, draws' seed)
CASES = {"E64": (64, 48, (0, 24, 36, 47), 2147483713, 2147483713),
         "E512": (512, 300, (0, 299), 2147483723, SEED)}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_six_car_kernel_equals_the_plain_step(card, case):
    n, steps, checked, reset_seed, seed = CASES[case]
    env = train_3v3.make_env(n, device=card)
    assert env.config.cars_per_arena == P and not env.portable
    assert env.obs_size == 225
    gen = torch.Generator(device=card).manual_seed(seed)
    state, _, _ = env.reset(reset_seed)
    tracing.reset()

    def check(phys, controls):
        got, live = kernel_and_plain(phys, controls, respawn_draws(gen, n, P),
                                     env.params, env.teams_np)
        compare(got, live.want, 0)
        return live.want.arena

    touched = 0
    for step in range(steps):
        controls = env.action_parser.parse(forward_or_random(env, gen))
        if step in checked:
            arena = check(state.phys, controls)
            touched += int(arena.cars.ball_hit_valid.any(-1).sum())
        phys = env.physics_step(state, controls)
        state, _ = env.post_physics(state, phys, controls)
    assert touched > 0                 # the played states had ball hits
    # the played state with the three opposing pairs driven into each
    # other: bumps and demos
    arena = check(head_on_6(state.phys, gen), controls)
    assert int((arena.step_bump | arena.step_demo).any(-1).sum()) >= n // 2
    assert counter("kernel.launches") == steps + len(checked) + 1

    # the post-physics graph against eager on the played state
    for _ in range(4):
        controls = env.action_parser.parse(forward_or_random(env, gen))
        phys = env.physics_step(state, controls)
        before = env.generator.get_state()
        graphed = env.post_physics(state, phys, controls)
        env.generator.set_state(before)
        assert_same(graphed, env._post_physics(state, phys, controls))
        state = graphed[0]
