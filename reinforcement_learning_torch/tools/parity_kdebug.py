"""Kernel-route (arena_step / ctick) parity debugging instrument (the twin
of the JAX package's ``tools/parity_kdebug.py``).

Three modes, all against the compiled reference oracle:

  python -m reinforcement_learning_torch.tools.parity_kdebug <scenario> [T]
      per-tick field dump of the KERNEL-route freerun vs the oracle
      (parity_debug's kernel twin) -- finds the divergence tick; with
      ``--ctick`` the plain version ``ops/ctick.py`` ``step`` directly.

  python -m reinforcement_learning_torch.tools.parity_kdebug <scenario> T
          --oracle-mf --from=A --to=B
      run the oracle with RS_ORACLE_DUMP=1 and print every persistent-
      manifold contact point in ticks [A, B] -- the ground-truth contact
      set at the divergence tick.

  python -m reinforcement_learning_torch.tools.parity_kdebug <scenario> T
          --rows=t [--car=N]
      teacher-force BOTH routes' car-world narrowphase to the oracle's
      state after tick t-1 and print their contact row sets side by side:
      the kernel route's facet+corner candidates/retained slots
      (ctick._facet_box_manifold) vs the portable engine's mesh-manifold
      + plane rows (contacts.resolve_car_world_mesh internals).  --ball
      prints the ball manifolds instead.

Every mode takes ``--device=cpu`` (default: the card) and
``--oracle=PATH`` (default: ``parity.ORACLE_BIN``).
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

from reinforcement_learning_torch.tools import (parity, parity_battery,
                                                parity_debug)


def run_ctick(sc, device=None):
    """Freerun the ctick component engine (the kernel's plain version)
    directly on one arena -- the same math as the kernel, on any
    device."""
    import torch

    from reinforcement_learning_torch.device import resolve_device
    from reinforcement_learning_torch.ops import ctick, pack
    from reinforcement_learning_torch.physics import step as stepmod

    dev = resolve_device(device)
    params = stepmod.ArenaParams(num_cars=sc.n_cars, use_mesh=True,
                                 dynamic_wheel_rays=True)
    teams = tuple(c.team for c in sc.cars)
    phys = parity._scenario_phys(sc, params, dev)
    batched = _batch(phys)
    k = ctick.make_consts(params, teams)
    ridx = torch.zeros((sc.n_cars, 1), dtype=torch.int32, device=dev)

    d = pack.to_components(batched)
    trace = {"ball": [], "cars": []}
    for t in range(sc.n_ticks):
        u = torch.as_tensor(np.asarray(sc.controls[t], np.float32),
                            device=dev)                     # (C, 8)
        nc = tuple(u[:, c].reshape(sc.n_cars, 1) for c in range(8))
        d = ctick.step(k, d, nc, ridx, 1, 0)
        b, cr = parity._trace_rows(pack.from_components(d).arena)
        trace["ball"].append(b[0])
        trace["cars"].append(cr[0])
    return {"ball": torch.stack(trace["ball"]).cpu().numpy(),
            "cars": torch.stack(trace["cars"]).cpu().numpy()}


def _batch(phys):
    """One arena's state with an arena axis of 1 in front."""
    from reinforcement_learning_torch.device import tree_map
    return tree_map(lambda a: a[None], phys)


def freerun(name, T, fields, backend="kernel", device=None, oracle_bin=None):
    sc = parity_battery.scenarios(T)[name]
    ref = parity.run_oracle([sc], oracle_bin=oracle_bin)[0]
    if backend == "ctick":
        ours = run_ctick(sc, device)
    else:
        ours = parity.run_torch_kernel([sc], device)[0]
    parity_debug.dump(ref, ours, T, fields)


def oracle_mf(name, T, t0, t1, oracle_bin=None):
    sc = parity_battery.scenarios(T)[name]
    oracle_bin = oracle_bin or parity.ORACLE_BIN
    if not os.path.exists(oracle_bin):
        raise FileNotFoundError(f"{oracle_bin}: no oracle binary there")
    cmf = parity.default_cmf_dir()
    with tempfile.TemporaryDirectory() as td:
        fin = os.path.join(td, "in.bin")
        fout = os.path.join(td, "out.bin")
        with open(fin, "wb") as f:
            f.write(parity._pack_scenarios([sc]))
        env = dict(os.environ, RS_ORACLE_DUMP="1")
        r = subprocess.run([oracle_bin, fin, fout, cmf],
                           capture_output=True, text=True, env=env,
                           timeout=600)
        for line in r.stderr.splitlines():
            if not line.startswith("MF t="):
                continue
            t = int(line.split()[1].split("=")[1])
            if t0 <= t <= t1:
                print(line)


def _phys_from_oracle(ref, sc, t, params, device=None):
    """PhysicsState (one arena, no arena axis) loaded from the oracle
    trace after tick t (cold internals -- good enough for narrowphase row
    dumps, which depend only on pose)."""
    import dataclasses

    import torch

    from reinforcement_learning_torch.physics import step as stepmod
    gcf = parity.car_trace_field
    phys = stepmod.make_physics_state(params, device=device)
    arena = phys.arena
    dev = arena.cars.pos.device
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32),  # noqa: E731
                                  device=dev)
    rot = np.stack([np.stack([gcf(ref["cars"], "fwd")[t, c],
                              gcf(ref["cars"], "right")[t, c],
                              gcf(ref["cars"], "up")[t, c]], axis=-1)
                    for c in range(sc.n_cars)])
    cars = dataclasses.replace(
        arena.cars, pos=f(gcf(ref["cars"], "pos")[t]), rot=f(rot),
        vel=f(gcf(ref["cars"], "vel")[t]),
        ang_vel=f(gcf(ref["cars"], "ang_vel")[t]))
    ball = dataclasses.replace(arena.ball, pos=f(ref["ball"][t, :3]),
                               vel=f(ref["ball"][t, 3:6]),
                               ang_vel=f(ref["ball"][t, 6:9]))
    return dataclasses.replace(phys, arena=dataclasses.replace(
        arena, cars=cars, ball=ball))


def rows(name, T, t, car=0, ball=False, device=None, oracle_bin=None):
    from reinforcement_learning_torch import constants as C
    from reinforcement_learning_torch.ops import ctick, pack
    from reinforcement_learning_torch.physics import step as stepmod

    sc = parity_battery.scenarios(T)[name]
    ref = parity.run_oracle([sc], oracle_bin=oracle_bin)[0]
    params = stepmod.ArenaParams(num_cars=sc.n_cars, use_mesh=True,
                                 dynamic_wheel_rays=True)
    teams = tuple(c.team for c in sc.cars)
    phys = _phys_from_oracle(ref, sc, t, params, device)
    k = ctick.make_consts(params, teams)

    batched = _batch(phys)
    st = pack.to_components(batched)

    np.set_printoptions(precision=4, suppress=True)
    if ball:
        _ball_rows(k, st, batched, params)
        return

    he = k.half_extents
    off = k.hitbox_offset
    brk = C.CONTACT_BREAK_FRAC * (
        float(np.linalg.norm(np.asarray(he)))
        + float(np.linalg.norm(np.asarray(off))))
    print(f"== kernel facet/corner manifold (brk={brk:.3f}) after "
          f"oracle tick {t} ==")
    slots = ctick._facet_box_manifold(k, _car_slice(st, car), brk)
    for i, (n, sup, dist, occ) in enumerate(slots):
        if bool(np.asarray(occ.cpu()).ravel()[0]):
            print(f"  slot{i}: n={_v(n)} sup={_v(sup)} "
                  f"dist={float(dist.reshape(-1)[0]):.4f}")

    print("== portable mesh manifold + plane rows ==")
    _xla_car_rows(batched, params, car)


def _car_slice(st, car):
    """Slice car ``car`` out of a component state dict (per-car fields
    ``(C, E)``; keeps the leading car axis of 1 the ctick helpers
    expect)."""
    import torch
    C = st["pos"][0].shape[0]

    def cut(a):
        if isinstance(a, torch.Tensor):
            return a[car:car + 1] if a.dim() >= 2 and a.shape[0] == C else a
        if isinstance(a, dict):
            return {k: cut(v) for k, v in a.items()}
        return type(a)(cut(v) for v in a)
    return {k: cut(v) for k, v in st.items()}


def _v(vec):
    return np.round(np.array([float(c.reshape(-1)[0]) for c in vec]), 4)


def _np(x):
    return x.detach().cpu().numpy()


def _xla_car_rows(phys, params, car):
    """The portable engine's car-world rows of car ``car`` (one arena,
    arena axis first): contacts.resolve_car_world_mesh's internals."""
    import torch

    from reinforcement_learning_torch import constants as C
    from reinforcement_learning_torch import maths as m
    from reinforcement_learning_torch.physics import arena_geom as geom
    from reinforcement_learning_torch.physics import box_tri, contacts
    from reinforcement_learning_torch.physics import world as worldmod
    from reinforcement_learning_torch.physics.mesh import (
        _closest_point_triangle, compact_sel)

    cars = phys.arena.cars
    dev = cars.pos.device
    grid = worldmod.get_grid(params.game_mode, dev)
    he_np = np.asarray(params.car_config.hitbox_size, np.float32) / 2
    off_np = np.asarray(params.car_config.hitbox_offset, np.float32)
    he = torch.as_tensor(he_np, device=dev)
    box_center = cars.pos + m.rotate(cars.rot,
                                     torch.as_tensor(off_np, device=dev))
    safe_margin = min(C.MESH_COLLISION_MARGIN, 0.1 * float(np.min(he_np)))
    brk = C.CONTACT_BREAK_FRAC * (float(np.linalg.norm(he_np))
                                  + float(np.linalg.norm(off_np)))
    idx = grid.candidates(box_center)
    a, ab, ac, tri_n = grid._gather(idx)
    cut = brk + safe_margin + 0.5
    cp0 = _closest_point_triangle(box_center[..., None, :], a, ab, ac)
    d0 = m.norm(box_center[..., None, :] - cp0)
    sphere_ok = d0 - float(np.linalg.norm(he_np)) <= cut
    plane_dist = torch.abs(torch.sum((box_center[..., None, :] - a) * tri_n,
                                     -1))
    proj = m.inv_rotate(cars.rot[..., None, :, :], tri_n)
    r_eff = torch.sum(torch.abs(proj) * he, dim=-1)
    plane_ok = plane_dist - r_eff <= cut
    near = (idx >= 0) & sphere_ok & plane_ok
    selk, ok = compact_sel(near, contacts.MESH_COMPACT_K_CAR)
    idx = torch.where(ok, m.take_along_axis(idx, selk, -1), -1)
    a, ab, ac, _ = grid._gather(idx)
    n_k, pt_k, dist_k = box_tri.box_triangle_contact(
        box_center[..., None, :], cars.rot[..., None, :, :], he,
        C.MESH_COLLISION_MARGIN, safe_margin, a, a + ab, a + ac)
    act_k = (idx >= 0) & (dist_k < brk)
    pos_a_k = pt_k + n_k * dist_k[..., None]
    local_a = pos_a_k - cars.pos[..., None, :]
    slot = contacts.manifold_insert(local_a, dist_k, act_k)
    mesh_act = _np(slot >= 0)[0]
    sel = torch.clamp(slot, min=0)
    idx4 = torch.where(slot >= 0, m.take_along_axis(idx, sel, -1), 0)
    n4 = m.take_along_axis(n_k, sel[..., None], -2)
    pt4 = m.take_along_axis(pt_k, sel[..., None], -2)
    mesh_dist = m.take_along_axis(dist_k, sel, -1)
    mesh_n, _ = grid.adjust_internal_edges(idx4, n4, pt4, mesh_dist)
    mesh_pt = m.take_along_axis(pos_a_k, sel[..., None], -2)

    cc = car
    idx_h, act_h = _np(idx)[0], _np(act_k)[0]
    n_h, pt_h, dist_h = _np(n_k)[0], _np(pt_k)[0], _np(dist_k)[0]
    # full candidate list first
    print(" candidates (pre-retention):")
    for kk in range(idx_h.shape[1]):
        if bool(act_h[cc, kk]):
            print(f"  tri{int(idx_h[cc, kk]):5d}: "
                  f"n={np.round(n_h[cc, kk], 4)} "
                  f"pt={np.round(pt_h[cc, kk], 2)} "
                  f"dist={float(dist_h[cc, kk]):.4f}")
    print(" retained slots (post internal-edge adjust):")
    mn, mp, md = _np(mesh_n)[0], _np(mesh_pt)[0], _np(mesh_dist)[0]
    for s in range(4):
        if mesh_act[cc, s]:
            print(f"  slot{s}: n={np.round(mn[cc, s], 4)} "
                  f"ptA={np.round(mp[cc, s], 2)} "
                  f"dist={float(md[cc, s]):.4f}")
    pn, pd = geom.get_planes(params.game_mode, dev)
    true_plane = geom.get_true_plane_mask(params.game_mode, dev)
    keep = torch.nonzero(true_plane)[:, 0]
    pn = pn[keep]
    pd = pd[keep]
    ldir = -m.inv_rotate(cars.rot[..., None, :, :], pn)
    sup_local = torch.where(ldir >= 0.0, he, -he)
    sup = box_center[..., None, :] + m.rotate(cars.rot[..., None, :, :],
                                              sup_local)
    sup_d = _np(m.dot(sup, pn) + pd)[0]
    sup_h, pn_h = _np(sup)[0], _np(pn)
    print(" plane rows:")
    for p in range(pn_h.shape[0]):
        d = float(sup_d[cc, p])
        if d < brk:
            print(f"  plane n={np.round(pn_h[p], 4)} "
                  f"sup={np.round(sup_h[cc, p], 2)} dist={d:.4f}")


def _ball_rows(k, st, phys, params):
    """The ball's manifolds: the kernel route's facet sphere manifold and
    the portable engine's mesh sphere manifold (one arena)."""
    import torch

    from reinforcement_learning_torch import constants as C
    from reinforcement_learning_torch import maths as m
    from reinforcement_learning_torch.ops import ctick
    from reinforcement_learning_torch.physics import contacts
    from reinforcement_learning_torch.physics import world as worldmod
    from reinforcement_learning_torch.physics.mesh import (
        _closest_point_triangle, compact_sel)

    mut = params.mutators
    radius = mut.ball_radius
    break_gap = C.CONTACT_BREAK_FRAC * (radius + C.SPHERE_BOUND_EXTRA)
    print(f"== kernel facet sphere manifold (break_gap={break_gap:.3f}) ==")
    slots = ctick._facet_sphere_manifold(k, st["ball_pos"], radius,
                                         break_gap)
    for i, (n, gap, occ) in enumerate(slots):
        if bool(occ.reshape(-1)[0]):
            print(f"  slot{i}: n={_v(n)} "
                  f"gap={float(gap.reshape(-1)[0]):.4f}")

    print("== portable mesh sphere manifold ==")
    ball = phys.arena.ball
    grid = worldmod.get_grid(params.game_mode, ball.pos.device)
    idx = grid.candidates(ball.pos)                       # (1, K)
    a, ab, ac, tri_n = grid._gather(idx)
    cp = _closest_point_triangle(ball.pos[:, None, :], a, ab, ac)
    delta = ball.pos[:, None, :] - cp
    dist_c = m.norm(delta)
    near = (idx >= 0) & (dist_c < radius + break_gap + 0.25)
    selk, ok = compact_sel(near, contacts.MESH_COMPACT_K_BALL)
    idx = torch.where(ok, m.take_along_axis(idx, selk, -1), -1)
    cp = m.take_along_axis(cp, selk[..., None], -2)
    delta = m.take_along_axis(delta, selk[..., None], -2)
    dist_c = m.take_along_axis(dist_c, selk, -1)
    tri_n = m.take_along_axis(tri_n, selk[..., None], -2)
    side = torch.sign(torch.sum(delta * tri_n, dim=-1, keepdim=True))
    side = torch.where(side == 0, 1.0, side)
    n_mesh = torch.where(dist_c[..., None] > 1e-6,
                         delta / torch.clamp(dist_c[..., None], min=1e-6),
                         tri_n * side)
    gap_mesh = dist_c - radius
    act_mesh = (idx >= 0) & (gap_mesh < break_gap)
    print(" candidates (pre-retention):")
    idx_h, act_h = _np(idx)[0], _np(act_mesh)[0]
    n_h, cp_h, gap_h = _np(n_mesh)[0], _np(cp)[0], _np(gap_mesh)[0]
    for kk in range(idx_h.shape[0]):
        if bool(act_h[kk]):
            print(f"  tri{int(idx_h[kk]):5d}: "
                  f"n_raw={np.round(n_h[kk], 4)} "
                  f"cp={np.round(cp_h[kk], 2)} "
                  f"gap={float(gap_h[kk]):.4f}")
    slot = contacts.manifold_insert(-n_mesh * radius, gap_mesh, act_mesh)
    sel = torch.clamp(slot, min=0)
    act4 = _np(slot >= 0)[0]
    idx4 = torch.where(slot >= 0, m.take_along_axis(idx, sel, -1), 0)
    n4, _ = grid.adjust_internal_edges(
        idx4, m.take_along_axis(n_mesh, sel[..., None], -2),
        m.take_along_axis(cp, sel[..., None], -2),
        m.take_along_axis(gap_mesh, sel, -1))
    n4_h = _np(n4)[0]
    gap4 = _np(m.take_along_axis(gap_mesh, sel, -1))[0]
    print(" retained slots (post internal-edge adjust):")
    for s in range(4):
        if act4[s]:
            print(f"  slot{s}: n={np.round(n4_h[s], 4)} "
                  f"gap={float(gap4[s]):.4f}")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    name = args[0]
    T = int(args[1]) if len(args) > 1 else 240
    t0, t1, row_t, car = 0, T, None, 0
    fields = ["pos", "vel", "ang_vel"]
    for a in sys.argv[1:]:
        if a.startswith("--from="):
            t0 = int(a.split("=")[1])
        if a.startswith("--to="):
            t1 = int(a.split("=")[1])
        if a.startswith("--rows="):
            row_t = int(a.split("=")[1])
        if a.startswith("--car="):
            car = int(a.split("=")[1])
        if a.startswith("--fields="):
            fields = a.split("=")[1].split(",")
    device = parity_battery.option("device")
    oracle_bin = parity_battery.option("oracle")
    if "--oracle-mf" in sys.argv:
        oracle_mf(name, T, t0, t1, oracle_bin)
    elif row_t is not None:
        rows(name, T, row_t, car=car, ball="--ball" in sys.argv,
             device=device, oracle_bin=oracle_bin)
    else:
        freerun(name, T, fields,
                backend="ctick" if "--ctick" in sys.argv else "kernel",
                device=device, oracle_bin=oracle_bin)


if __name__ == "__main__":
    main()
