"""The floating-point work of one physics env step on given data.

The plain version (``ops/ctick.py``) is branch-free: every contact solver
runs for every plane, wheel, car pair and the ball on every tick, and a
select keeps its result where the contact exists.  A solver without its
contact changes nothing, so the least work the step needs on these inputs
leaves it out.  ``step_work`` runs the plain version under a dispatch
counter that counts, for every elementwise float arithmetic op, its output
elements (selects, compares and copies are not counted), and weights the
ops inside each gated call by the share of its lanes whose gate is set.
The gates (``GATES``): the plane, ball and car-ball solvers where their
contact exists; the car-pair box manifold and pair solver where the pair
overlaps (the separating-axis test that decides it is counted in full);
wheel friction and suspension where the ray hit; at full fidelity, each
facet query of a car or the ball where one of its own rows is live (the
band and goal facets, the floor grid and the ceiling grid separately), so
a ball resting on the floor grid counts the grid's rows and not the walls'
and goal's; the 4-slot retention on its live candidates only; the rest of
a manifold where a slot is occupied; the facet raycast where it hits a
facet; and the joint PGS where a row is live.  In the game modes:
heatseeker steering where the ball seeks a goal (``hs_y_target_dir`` not
0); each snowday plane row where the plane is valid and within the
puck's break distance, and its 10-pass contact (``_contact_vs_static``)
where the puck touches.  (The kernel skips the plane, ball and car-ball
solvers without contact, the facet items and wheel-ray bands its culls
rule out, the inactive PGS rows, and the box manifold and pair solver of
car pairs apart; it still evaluates each cull and each surviving facet
item's rows.)
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import operator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench.reference.rlt.ops import ctick
from perfbench.reference.rlt.physics import box_box
from perfbench.reference.rlt.physics import facet_arena

ARITH = frozenset({
    "add", "sub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "sin", "cos",
    "atan2", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "pow",
    "reciprocal", "fmod", "sum", "exp", "log", "rsub"})


def _wheel_hits(args, out):
    return torch.stack(args["rc"]["hit"])


def _any(masks):
    return functools.reduce(operator.or_, masks)


# (module, function) -> the lanes of a call that need its work, from the
# call's arguments and its output
GATES = {
    (ctick, "_contact_vs_static"): lambda a, out: a["active"],
    (ctick, "_car_ball_rows"): lambda a, out: a["touching"],
    (ctick, "_pgs_pair"): lambda a, out: _any(a["act"]),
    (ctick, "_calc_friction_impulses"): _wheel_hits,
    (ctick, "_apply_suspension"): _wheel_hits,
    (ctick, "_apply_friction_impulses"): _wheel_hits,
    (box_box, "_manifold"): lambda a, out: (~a["sat"]["separated"]
                                            & (a["sat"]["code"] > 0)),
    # full fidelity: each query where one of its rows is live, the
    # retention weighted by its live candidates' share, the rest of a
    # manifold where slot 0 is occupied (iff any candidate is live)
    (facet_arena, "sphere_contacts"): lambda a, out: out[4].any(0),
    (facet_arena, "box_contacts"): lambda a, out: out[7].any(0),
    (facet_arena, "sheet_sphere_contacts"):
        lambda a, out: _any([row[6] for row in out]),
    (facet_arena, "sheet_box_contacts"):
        lambda a, out: _any([row[7] for row in out]),
    (ctick, "keep_diverse4"): lambda a, out: (a["d"] < 1e30).float().mean(0),
    (ctick, "_facet_box_manifold"): lambda a, out: out[0][3],
    (ctick, "_facet_sphere_manifold"): lambda a, out: out[0][2],
    (facet_arena, "raycasts"): lambda a, out: out[4],
    (ctick, "_pgs_rows"): lambda a, out: _any([r[3] for r in a["rows"]]),
    # game modes
    (ctick, "_hs_steer"): lambda a, out: a["st"]["ball_hs"][0] != 0,
    (ctick, "_snow_plane_row"): lambda a, out: out[0],
}


class _Counter(TorchDispatchMode):
    """Counts arithmetic output elements into the innermost open frame,
    and every op dispatched."""

    def __init__(self):
        super().__init__()
        self.frames = [0]
        self.calls = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        self.calls += 1
        if (func.__name__.split(".")[0].rstrip("_") in ARITH
                and isinstance(out, torch.Tensor)
                and out.dtype.is_floating_point):
            self.frames[-1] += out.numel()
        return out


def count_ops(fn):
    """(elementwise float arithmetic output elements, tensor ops
    dispatched) of ``fn()``, all branches counted."""
    counter = _Counter()
    with counter:
        fn()
    return counter.frames[0], counter.calls


@dataclasses.dataclass
class StepWork:
    out: object               # the next PhysicsState
    ops_needed: float         # gated solvers counted on their live lanes
    ops_branch_free: float    # every op the plain version ran
    by_gate: dict             # function name -> (needed, branch-free) ops


def step_work(phys, new_controls, respawn_idx, consts, tick_skip: int = 8,
              action_delay: int = 7) -> StepWork:
    """``ctick.arena_step_reference`` on these inputs, with its work."""
    counter = _Counter()
    full = {name: 0 for _, name in GATES}
    needed = {name: [] for _, name in GATES}

    def gated(gate, name, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            counter.frames.append(0)
            try:
                out = fn(*args, **kw)
            finally:
                ops = counter.frames.pop()
            counter.paused = True
            share = gate(sig.bind(*args, **kw).arguments, out)
            needed[name].append(ops * share.float().mean())
            counter.paused = False
            full[name] += ops
            return out
        return wrapper

    saved = {key: getattr(*key) for key in GATES}
    try:
        for (mod, name), fn in saved.items():
            setattr(mod, name, gated(GATES[mod, name], name, fn))
        with counter:
            out = ctick.arena_step_reference(phys, new_controls, respawn_idx,
                                             consts, tick_skip, action_delay)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    by_gate = {name: (float(sum(needed[name])) if needed[name] else 0.0,
                      float(full[name])) for name in full}
    ungated = counter.frames[0]
    return StepWork(
        out=out,
        ops_needed=ungated + sum(n for n, _ in by_gate.values()),
        ops_branch_free=ungated + sum(f for _, f in by_gate.values()),
        by_gate=by_gate)
