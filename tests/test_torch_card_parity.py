"""The parity instruments (``tools/parity*.py`` twins) on the card, against
the reference oracle (``tools/oracle/build-fma/rs_oracle``, run on the
host beside the card's work).

Marked ``card``: skips without one (``tests/torch_card.py`` has the
command).

- the 26-scenario battery of 240 ticks through the oracle, the kernel
  route (``parity.run_torch_kernel``: tick_skip 1, action delay 0, the 24
  one-car scenarios as one arena axis and the 2 two-car ones as another,
  240 launches each) and the portable engine (``parity.run_torch``, no
  kernel launch): PARITY.md's exact rows (driving, steering, powerslide,
  boost, jumps, the ball drop, the bump) within the BallState::Matches
  margins with no flag differing, on both routes;
- the kernel at the battery's launch shape against its plain version at 5
  ticks of each group, within ``ops.ctick.DEFAULT_TOLERANCE`` on every
  float, no flag differing;
- one teacher-forced ``front_flip`` through the kernel: 239 launches,
  finite errors.
"""

from __future__ import annotations

import concurrent.futures
import math

import pytest

from reinforcement_learning_torch.ops import arena_step as A
from reinforcement_learning_torch.ops import ctick
from reinforcement_learning_torch.tools import (parity, parity_battery,
                                                parity_teacher)
from reinforcement_learning_torch.utils import tracing
from torch_card import battery_group, card, compare, counter

PARITY_T = 240
# BallState::Matches (Ball.h:38): pos 0.8 uu, vel 0.4 uu/s, ang_vel 0.02
MARGINS = dict(car_pos=0.8, car_vel=0.4, car_ang=0.02, ball_pos=0.8,
               ball_vel=0.4)
# PARITY.md's rows that are exact on both JAX engines: gated on both routes
EXACT_ROWS = ("drive_forward", "drive_reverse", "steer_circle", "powerslide",
              "boost_ground", "jump_short", "jump_held", "double_jump",
              "ball_drop", "car_bump")
# battery ticks at which the kernel is held against its plain version
CHECK_TICKS = (0, 60, 120, 180, 239)


@pytest.fixture(scope="module")
def battery():
    """The battery's scenarios by name, and their names by car count."""
    scs = parity_battery.scenarios(PARITY_T)
    groups = {}
    for name, sc in scs.items():
        groups.setdefault(sc.n_cars, []).append(name)
    return scs, groups


@pytest.fixture(scope="module")
def routes(battery, card):
    """Each scenario's errors against the oracle on the kernel route and on
    the portable engine, and each route's kernel launches (the kernel's
    per car count)."""
    scs, groups = battery
    names = list(scs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # a process of its own on the host, beside the card's work
        oracle = pool.submit(parity.run_oracle, [scs[n] for n in names])
        traces, launches = {}, {}
        for n_cars, group in sorted(groups.items()):
            tracing.reset()
            traces.update(zip(group, parity.run_torch_kernel(
                [scs[n] for n in group], device=card)))
            launches[n_cars] = counter("kernel.launches")
        tracing.reset()
        portable = dict(zip(names, parity.run_torch(
            [scs[n] for n in names], device=card)))
        launches["portable"] = counter("kernel.launches")
        refs = dict(zip(names, oracle.result()))
    return {"launches": launches,
            "kernel": {n: parity_battery.errors(refs[n], traces[n])
                       for n in names},
            "portable": {n: parity_battery.errors(refs[n], portable[n])
                         for n in names}}


@pytest.mark.card
def test_battery_groups(battery):
    _, groups = battery
    assert sorted(groups) == [1, 2] and len(groups[2]) == 2


@pytest.mark.card
def test_route_launches(routes):
    assert routes["launches"] == {1: PARITY_T, 2: PARITY_T, "portable": 0}


@pytest.mark.card
@pytest.mark.parametrize("route", ["kernel", "portable"])
def test_exact_rows_within_the_margins(routes, route):
    errs = routes[route]
    bad = [(n, [k for k, m in MARGINS.items() if errs[n][k] > m],
            errs[n]["flags"]) for n in EXACT_ROWS]
    assert [b for b in bad if b[1] or b[2]] == []


@pytest.mark.card
@pytest.mark.parametrize("n_cars", [1, 2])
def test_kernel_equals_plain_at_the_battery_shape(battery, card, n_cars):
    """The scenarios of one car count as one arena axis, stepped by the
    kernel through the battery's ticks; at ``CHECK_TICKS`` the kernel and
    the plain version step the same state and controls."""
    scs, groups = battery
    phys, ctl_all, r, params, teams = battery_group(
        [scs[n] for n in groups[n_cars]], card)
    consts = A._consts(params, teams)
    for t in range(PARITY_T):
        got = A.arena_step(phys, ctl_all[t], r, params, teams, 1, 0)
        if t in CHECK_TICKS:
            want = ctick.arena_step_reference(phys, ctl_all[t], r, consts,
                                              1, 0)
            compare(got, want, 0, tolerance=ctick.DEFAULT_TOLERANCE)
        phys = got


@pytest.mark.card
def test_teacher_forced_front_flip(card):
    tracing.reset()
    worst = parity_teacher.run("front_flip", PARITY_T, quiet=True,
                               backend="ctick", device=card)
    assert counter("kernel.launches") == PARITY_T - 1
    assert all(math.isfinite(v) for v in worst.values())
