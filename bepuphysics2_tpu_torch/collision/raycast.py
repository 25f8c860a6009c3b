"""Scene ray casting: every (ray, collidable) pair's analytic intersection, then a masked
min-t reduction.

Counterpart of ``bepuphysics2_tpu/collision/raycast.py`` (reference Trees/Tree_RayCast.cs,
Simulation_Queries.cs:167, Trees/RayBatcher.cs:125): the sphere, capsule, box, cylinder
and triangle testers of the reference's shapes (Collidables/*.cs RayTest), one pass over
every body and, for compounds and meshes, one pass over their children.

The JAX package tests each body's children through a window as wide as the largest
child count of any registered shape, an (R, N, W) grid. The port tests the same children
as a flat list of (owner body, child row) targets that the host enumerates from the
registry, an (R, K) grid, and then picks exactly the body the JAX reduction picks: the
least t, ties to the lowest body slot (the full pass) or to the earliest candidate (the
pruned pass), and within a body to the first child in pool order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bodies import KIND_EMPTY, BodyState
from ..shapes.registry import BOX, CAPSULE, CYLINDER, SPHERE, TRIANGLE, ShapeData
from ..utils import replay
from ..utils.vec import Quat, Vec3

_INF = 3.0e38


class RayHit(NamedTuple):
    hit: torch.Tensor  # bool
    t: torch.Tensor  # distance along the (unnormalised) direction
    body: torch.Tensor  # int32 body slot (-1 = miss)
    normal: Vec3  # world-space surface normal at the hit
    # prune_k only (None otherwise): True where the K-candidate budget filled with the
    # K-th candidate's entry bound <= the returned t, so an unexamined body could hit
    # earlier; re-cast those rays with prune_k=0 where exactness matters.
    saturated: torch.Tensor = None


def _ray_sphere(o: Vec3, d: Vec3, radius):
    """Ray from o along d vs an origin-centred sphere: (t, normal, hit)."""
    a = d.dot(d)
    b = 2.0 * o.dot(d)
    c = o.dot(o) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0 = (-b - sq) / (2.0 * a).clamp_min(1e-30)
    t1 = (-b + sq) / (2.0 * a).clamp_min(1e-30)
    t = torch.where(t0 >= 0.0, t0, t1)
    hit = (disc >= 0.0) & (t >= 0.0)
    return t, (o + d * t).normalize(), hit


def _safe_inv(x):
    return 1.0 / torch.where(x.abs() > 1e-12, x, torch.where(x >= 0, 1e-12, -1e-12))


def _ray_box(o: Vec3, d: Vec3, h: Vec3):
    """Slab test vs an origin-centred box of half extents h."""
    inv = Vec3(_safe_inv(d.x), _safe_inv(d.y), _safe_inv(d.z))
    t1 = Vec3((-h.x - o.x) * inv.x, (-h.y - o.y) * inv.y, (-h.z - o.z) * inv.z)
    t2 = Vec3((h.x - o.x) * inv.x, (h.y - o.y) * inv.y, (h.z - o.z) * inv.z)
    tmin_v = t1.min(t2)
    tmax_v = t1.max(t2)
    tmin = torch.maximum(tmin_v.x, torch.maximum(tmin_v.y, tmin_v.z))
    tmax = torch.minimum(tmax_v.x, torch.minimum(tmax_v.y, tmax_v.z))
    hit = (tmax >= tmin) & (tmax >= 0.0)
    t = tmin.clamp_min(0.0)
    # The normal: the axis that set tmin, against the ray.
    is_x = tmin == tmin_v.x
    is_y = ~is_x & (tmin == tmin_v.y)
    n = Vec3(
        torch.where(is_x, -torch.sign(d.x), 0.0),
        torch.where(is_y, -torch.sign(d.y), 0.0),
        torch.where(~(is_x | is_y), -torch.sign(d.z), 0.0),
    )
    return t, n, hit


def _ray_side(o: Vec3, d: Vec3, radius, half_length):
    """The side of a Y-axis cylinder of the given radius, clamped to |y| <= half_length:
    (t, normal, ok)."""
    a = d.x * d.x + d.z * d.z
    b = 2.0 * (o.x * d.x + o.z * d.z)
    c = o.x * o.x + o.z * o.z - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    safe_a = a.clamp_min(1e-30)
    ts0 = (-b - sq) / (2.0 * safe_a)
    ts1 = (-b + sq) / (2.0 * safe_a)
    ts = torch.where(ts0 >= 0.0, ts0, ts1)
    y_at = o.y + d.y * ts
    ok = (disc >= 0.0) & (a > 1e-12) & (ts >= 0.0) & (y_at.abs() <= half_length)
    n = Vec3(o.x + d.x * ts, torch.zeros_like(ts), o.z + d.z * ts).normalize()
    return ts, n, ok


def _ray_capsule(o: Vec3, d: Vec3, radius, half_length):
    """Ray vs a Y-axis capsule: the side, then the two end spheres."""
    ts, side_n, side_ok = _ray_side(o, d, radius, half_length)
    t_top, n_top, hit_top = _ray_sphere(Vec3(o.x, o.y - half_length, o.z), d, radius)
    t_bot, n_bot, hit_bot = _ray_sphere(Vec3(o.x, o.y + half_length, o.z), d, radius)
    t = torch.where(side_ok, ts, _INF)
    t_cap_top = torch.where(hit_top, t_top, _INF)
    t_cap_bot = torch.where(hit_bot, t_bot, _INF)
    t_all = torch.minimum(t, torch.minimum(t_cap_top, t_cap_bot))
    n = n_top.where(t_cap_top == t_all, side_n)
    n = n_bot.where(t_cap_bot == t_all, n)
    n = side_n.where(t == t_all, n)
    return t_all, n, t_all < _INF


def _ray_cylinder(o: Vec3, d: Vec3, radius, half_length):
    """Ray vs a Y-axis cylinder: the side, then the flat caps at y = +-half_length."""
    ts, side_n, side_ok = _ray_side(o, d, radius, half_length)
    safe_dy = torch.where(d.y.abs() > 1e-12, d.y, 1e-12)
    t_up = (half_length - o.y) / safe_dy
    t_dn = (-half_length - o.y) / safe_dy

    def cap_ok(t_cap):
        px = o.x + d.x * t_cap
        pz = o.z + d.z * t_cap
        return (d.y.abs() > 1e-12) & (t_cap >= 0.0) & (px * px + pz * pz <= radius * radius)

    t = torch.where(side_ok, ts, _INF)
    t_u = torch.where(cap_ok(t_up), t_up, _INF)
    t_d = torch.where(cap_ok(t_dn), t_dn, _INF)
    t_all = torch.minimum(t, torch.minimum(t_u, t_d))
    dev = t_all.device
    n = Vec3.full(t_all.shape, 0.0, 1.0, 0.0, device=dev).where(t_u == t_all, side_n)
    n = Vec3.full(t_all.shape, 0.0, -1.0, 0.0, device=dev).where(t_d == t_all, n)
    n = side_n.where(t == t_all, n)
    return t_all, n, t_all < _INF


def _ray_triangle(o: Vec3, d: Vec3, va: Vec3, vb: Vec3, vc: Vec3):
    """Moller-Trumbore, two-sided (a mesh's one-sidedness is the contact pipeline's); the
    normal faces the ray."""
    e1 = vb - va
    e2 = vc - va
    p = d.cross(e2)
    det = e1.dot(p)
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    s = o - va
    u = s.dot(p) * inv_det
    q = s.cross(e1)
    v = d.dot(q) * inv_det
    t = e2.dot(q) * inv_det
    hit = (det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    n = e1.cross(e2).normalize()
    n = n.where(n.dot(d) < 0.0, -1.0 * n)
    return t, n, hit


def _tri(p):
    return (Vec3(p[..., 0], p[..., 1], p[..., 2]), Vec3(p[..., 3], p[..., 4], p[..., 5]),
            Vec3(p[..., 6], p[..., 7], p[..., 8]))


def _cast_shapes(stype, params, o: Vec3, d: Vec3, types=(SPHERE, CAPSULE, BOX, CYLINDER,
                                                            TRIANGLE)):
    """The analytic testers of ``types`` in the shapes' local frames, selected by type:
    (t, local normal), t = _INF at misses and for every other type."""
    t = torch.full(torch.broadcast_shapes(stype.shape, o.x.shape, d.x.shape), _INF,
                   device=stype.device)
    n = Vec3.zeros(t.shape, device=t.device)
    for type_id in types:
        if type_id == SPHERE:
            tt, nn, hh = _ray_sphere(o, d, params[..., 0])
        elif type_id == CAPSULE:
            tt, nn, hh = _ray_capsule(o, d, params[..., 0], params[..., 1])
        elif type_id == BOX:
            tt, nn, hh = _ray_box(o, d, Vec3(params[..., 0], params[..., 1], params[..., 2]))
        elif type_id == CYLINDER:
            tt, nn, hh = _ray_cylinder(o, d, params[..., 0], params[..., 1])
        else:
            tt, nn, hh = _ray_triangle(o, d, *_tri(params))
        sel = (stype == type_id) & hh
        t = torch.where(sel, tt, t)
        n = nn.where(sel, n)
    return t, n


_TESTED = (SPHERE, CAPSULE, BOX, CYLINDER, TRIANGLE)


def _cast_bodies(pos: Vec3, orn: Quat, shape, shapes: ShapeData, o_b: Vec3, d_b: Vec3,
                 types=_TESTED):
    """Each collidable's own shape (compounds and meshes miss here): (t, local normal).
    ``types``: the tested types that can occur (the others miss everywhere)."""
    shape_id = shape.clamp_min(0).long()
    stype = torch.where(shape >= 0, shapes.type[shape_id], -1)
    local_o = orn.rotate_inverse(o_b - pos)
    local_d = orn.rotate_inverse(d_b)
    return _cast_shapes(stype, shapes.params[shape_id], local_o, local_d, types)


def _cast_children(state: BodyState, shapes: ShapeData, owner, rows, o_b: Vec3, d_b: Vec3,
                   types=_TESTED):
    """Each child target (a mesh triangle, or a compound's sphere, capsule, box or
    cylinder child) in its owner's frame: (t, normal in the owner's frame). ``types``:
    the child types that can occur (TRIANGLE for a mesh's)."""
    pos, orn = state.pos[owner], state.orn[owner]
    lo = orn.rotate_inverse(o_b - pos)
    ld = orn.rotate_inverse(d_b)
    cs = shapes.child_shape[rows]
    is_tri = cs < 0
    convex = tuple(t for t in types if t != TRIANGLE)
    if TRIANGLE in types:
        tt, tn, th = _ray_triangle(lo, ld, *_tri(shapes.child_tri[rows]))
    if not convex:  # mesh triangles only
        return torch.where(is_tri & th, tt, _INF), tn
    cs_c = cs.clamp_min(0).long()
    cp, co = shapes.child_pos[rows], shapes.child_orn[rows]
    corn = Quat(co[:, 0], co[:, 1], co[:, 2], co[:, 3])
    o_c = corn.rotate_inverse(lo - Vec3(cp[:, 0], cp[:, 1], cp[:, 2]))
    d_c = corn.rotate_inverse(ld)
    ctype = torch.where(is_tri, -1, shapes.type[cs_c])
    st, sn = _cast_shapes(ctype, shapes.params[cs_c], o_c, d_c, types=convex)
    if TRIANGLE not in types:  # no mesh
        return st, corn.rotate(sn)
    t = torch.where(is_tri & th, tt, st)
    return t, tn.where(is_tri, corn.rotate(sn))


def _first_min(t, key):
    """Per row, the column of the least t, ties to the least ``key``: (column, t)."""
    tmin = t.min(dim=-1, keepdim=True).values
    col = torch.where(t == tmin, key, torch.iinfo(torch.int64).max).argmin(dim=-1)
    return col, tmin[..., 0]


def _take(x, col):
    return x.gather(-1, col[..., None])[..., 0]


def ray_cast_all(state: BodyState, shapes: ShapeData, origin: Vec3, direction: Vec3, max_t,
                 exclude=None, child_owner=None, child_rows=None, prune_k: int = 0,
                 body_types=_TESTED, child_types=_TESTED) -> RayHit:
    """Cast ray(s) against every collidable and reduce to the least t. ``origin`` and
    ``direction`` have scalar components (one ray) or (R,) components (a batch).
    ``exclude``: a body slot to skip. ``child_owner`` / ``child_rows``: (K,) the owner
    slot and child-pool row of every child of every compound and mesh body, in body slot
    order (``Simulation._child_targets``); None: no compound or mesh body.

    ``prune_k`` > 0 (batched rays only): a bounding-sphere pass over every body ranks
    them by a conservative lower bound on their hit time, and only the ``prune_k``
    earliest (a stable sort: ties to the lower slot, as ``lax.top_k``) are tested.

    ``body_types`` / ``child_types``: the shape types that the bodies and the child
    targets can have (the host knows them); the testers of the others, which would miss
    everywhere, are not run.

    On a CUDA device the cast replays as one CUDA graph per layout from its second call
    (``utils/replay.py``): a character's support ray, cast once a tick, is one launch."""
    dev = state.pos.x.device
    batched = origin.x.dim() > 0
    has_children = child_owner is not None and child_owner.shape[0] > 0
    inputs = dict(
        bodies=_Bodies(state.pos, state.orn, state.kind, state.shape),
        shapes=_Shapes(shapes.type, shapes.params, shapes.max_radius, shapes.child_shape,
                       shapes.child_pos, shapes.child_orn, shapes.child_tri),
        origin=origin, direction=direction,
        max_t=(max_t.to(torch.float32) if torch.is_tensor(max_t)
               else torch.full((), max_t, dtype=torch.float32, device=dev)),
        exclude=torch.full((), -1 if exclude is None else exclude, dtype=torch.int64,
                           device=dev),
    )
    if has_children:
        inputs.update(child_owner=child_owner, child_rows=child_rows)
    key = ("ray_cast_all", batched, prune_k, tuple(body_types), tuple(child_types))
    hit, t, body, normal, saturated = replay.run(
        key, lambda x: _cast_all(x, batched, prune_k, body_types, child_types), inputs)
    pruned = prune_k and batched and prune_k < state.pos.x.shape[0]
    return RayHit(hit, t, body, normal, saturated if pruned else None)


class _Bodies(NamedTuple):
    """The body columns a ray cast reads."""

    pos: Vec3
    orn: Quat
    kind: torch.Tensor
    shape: torch.Tensor


class _Shapes(NamedTuple):
    """The registry columns a ray cast reads."""

    type: torch.Tensor
    params: torch.Tensor
    max_radius: torch.Tensor
    child_shape: torch.Tensor
    child_pos: torch.Tensor
    child_orn: torch.Tensor
    child_tri: torch.Tensor


def _cast_all(x, batched, prune_k, body_types, child_types):
    """``ray_cast_all`` over the tensors of ``x``: (hit, t, body, normal, saturated), the
    last a placeholder where there is no prune."""
    state, shapes = x["bodies"], x["shapes"]
    origin, direction, max_t = x["origin"], x["direction"], x["max_t"]
    n_bodies = state.pos.x.shape[0]
    dev = state.pos.x.device
    if not batched:
        origin, direction = origin[None], direction[None]
    o_b = origin[:, None]
    d_b = direction[:, None]
    max_t_b = max_t[:, None] if max_t.dim() > 0 else max_t
    n_rays = o_b.x.shape[0]
    exists = ((state.kind != KIND_EMPTY) & (state.shape >= 0)
              & (torch.arange(n_bodies, device=dev) != x["exclude"]))
    has_children = "child_owner" in x
    if has_children:
        child_owner, child_rows = x["child_owner"], x["child_rows"]
        owner = child_owner.long()
        rows = child_rows.clamp_min(0).long()
        live_child = (child_owner >= 0) & exists[owner]
        order = torch.arange(owner.shape[0], device=dev)

    saturated = None
    if prune_k and batched and prune_k < n_bodies:
        # Phase 1: conservative entry times against every body's bounding sphere.
        r_bound = shapes.max_radius[state.shape.clamp_min(0).long()]
        rel = o_b - state.pos
        dd = d_b.dot(d_b).clamp_min(1e-30)
        tproj = -rel.dot(d_b) / dd
        tc = torch.minimum(tproj.clamp_min(0.0), max_t_b)
        closest = rel + d_b * tc
        miss = closest.dot(closest) > r_bound * r_bound
        entry = (tproj - r_bound / torch.sqrt(dd)).clamp_min(0.0)
        entry = torch.where(miss | ~exists, _INF, entry)
        ranked = torch.sort(entry, dim=-1, stable=True)
        idx = ranked.indices[:, :prune_k]
        kth = ranked.values[:, prune_k - 1]
        cand_live = ranked.values[:, :prune_k] < _INF
        t, n_local = _cast_bodies(state.pos[idx], state.orn[idx], state.shape[idx], shapes,
                                  o_b, d_b, body_types)
        t = torch.where(cand_live & (t <= max_t_b), t, _INF)
        col = torch.argmin(t, dim=-1)
        best_t = _take(t, col)
        best = _take(idx, col)
        n_sel = Vec3(*(_take(c, col) for c in n_local))
        if has_children:
            # A child counts where its owner is a live candidate, ranked as its owner.
            rank = torch.full((n_rays, n_bodies), prune_k, dtype=torch.int64, device=dev)
            pos_k = torch.arange(prune_k, device=dev).expand(n_rays, prune_k)
            rank.scatter_(1, idx, torch.where(cand_live, pos_k, prune_k))
            c_rank = rank[:, owner]
            tc_, nc = _cast_children(state, shapes, owner, rows, o_b, d_b, child_types)
            tc_ = torch.where((c_rank < prune_k) & live_child & (tc_ <= max_t_b), tc_, _INF)
            ccol, ct = _first_min(tc_, c_rank * owner.shape[0] + order)
            take_child = (ct < best_t) | ((ct == best_t) & (_take(c_rank, ccol) < col))
            best_t = torch.where(take_child, ct, best_t)
            best = torch.where(take_child, owner[ccol], best)
            n_sel = Vec3(*(_take(c, ccol) for c in nc)).where(take_child, n_sel)
        saturated = cand_live[:, -1] & (kth <= torch.minimum(best_t, max_t))
    else:
        t, n_local = _cast_bodies(state.pos, state.orn, state.shape, shapes, o_b, d_b,
                                  body_types)
        t = torch.where(exists & (t <= max_t_b), t, _INF)
        best = torch.argmin(t, dim=-1)
        best_t = _take(t, best)
        n_sel = Vec3(*(_take(c, best) for c in n_local))
        if has_children:
            tc_, nc = _cast_children(state, shapes, owner, rows, o_b, d_b, child_types)
            tc_ = torch.where(live_child & (tc_ <= max_t_b), tc_, _INF)
            ccol = torch.argmin(tc_, dim=-1)  # child targets are in body slot order
            ct = _take(tc_, ccol)
            take_child = (ct < best_t) | ((ct == best_t) & (owner[ccol] < best))
            best_t = torch.where(take_child, ct, best_t)
            best = torch.where(take_child, owner[ccol], best)
            n_sel = Vec3(*(_take(c, ccol) for c in nc)).where(take_child, n_sel)
    world_n = state.orn[best].rotate(n_sel)
    hit = best_t < _INF
    out = (hit, torch.where(hit, best_t, max_t), torch.where(hit, best.to(torch.int32), -1),
           world_n.where(hit, Vec3.zeros(hit.shape, device=dev)),
           hit if saturated is None else saturated)
    if not batched:
        out = tuple(v[0] for v in out)
    return out
