"""Shape sweeps and CCD: time of impact by conservative advancement against every
collidable or over an explicit pair set.

Counterpart of ``sweep_shape_all`` and ``pair_toi`` in
``bepuphysics2_tpu/collision/sweeps.py`` (reference SweepTasks/ConvexSweepTaskCommon.cs:
116-230, Simulation_Queries.cs:267, NarrowPhaseCCDContinuations): a fixed number of
iterations (``SWEEP_ITERS`` for a sweep, 12 for CCD) of

    d <- GJK distance between the shapes posed at time t
    done if d < 1e-4 (impact) or t > max_t (miss)
    t <- t + d / (a bound on the approach speed)

over flat records, with the port's own ``convex.gjk_closest``. Sweep targets are (owner
body, local pose, convex shape): each plain body, and each child of a compound or mesh
body (the host enumerates them), the compound itself left out. A batch of R sweeps is one
pass over (R, T) records, not R calls.

On a CUDA device the advancement of every record runs in kernel K8
(``csrc/conservative_advance.cu``, ``conservative_advance``): one thread runs a record's
whole loop. A registered custom shape's support is a Python function, which no kernel
can call: where one may occur (decided on the host from the types present) the masked
loop runs as PyTorch ops instead, replayed as one CUDA graph per layout on the card
(``utils/replay.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..bodies import BodyState
from ..ops import build
from ..shapes.custom import CUSTOM_SUPPORTS
from ..shapes.registry import BIG_COMPOUND, COMPOUND, MESH, TRIANGLE, ShapeData, ShapeRegistry
from ..utils import replay
from ..utils.vec import Quat, Vec3, integrate_orientation
from .convex import SupportCtx, gjk_closest

SWEEP_ITERS = 32
_INF = 3.0e38


class SweepHit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    body: torch.Tensor
    # prune_k only (None otherwise): True where the K-candidate budget filled with
    # candidates whose entry bound precedes the returned t, so the result may not be the
    # earliest impact; re-sweep with prune_k=0 where exactness matters.
    saturated: torch.Tensor = None


def _advance(x, custom_ids=(), iters: int = SWEEP_ITERS, miss_max_t: bool = False):
    """The conservative advancement of every record: (n,) time of impact, or the miss
    value where none within max_t (3e38, or the record's ``max_t`` where
    ``miss_max_t``). ``x`` holds flat per-record tensors (``conservative_advance``).
    K8's plain version."""
    sa = x["sweep"]
    ctx0 = SupportCtx(
        type_a=x["type_a"], params_a=x["params_a"], type_b=x["type_b"],
        params_b=x["params_b"], orn_ab=None, pos_ab=None, hull_points=x["hull_points"],
        hull_rows_a=x["hull_a"], hull_rows_b=x["hull_b"], custom_ids=custom_ids)

    def ctx_at(t):
        a_pos = sa["pos"] + sa["vel"] * t
        a_orn = integrate_orientation(sa["orn"], sa["omega"], t)
        ow_pos = x["o_pos"] + x["o_vel"] * t
        ow_orn = integrate_orientation(x["o_orn"], x["o_omega"], t)
        b_pos = ow_pos + ow_orn.rotate(x["lpos"])
        b_orn = ow_orn.mul(x["lorn"])
        return ctx0._replace(orn_ab=a_orn.conjugate().mul(b_orn),
                             pos_ab=a_orn.rotate_inverse(b_pos - a_pos))

    speed_bound = x["speed_bound"]
    max_t = x["max_t"]
    t = torch.zeros_like(speed_bound)
    done = ~x["exists"]
    hit_t = max_t.clone() if miss_max_t else torch.full_like(speed_bound, _INF)
    for _ in range(iters):
        dist, _, _, margin = gjk_closest(ctx_at(t))
        dist = dist - margin  # the surface distance, radii included
        impact = dist < 1e-4
        hit_t = torch.where(impact & ~done, t, hit_t)
        new_t = t + torch.clamp_min(dist.clamp_min(0.0) / speed_bound, 1e-5)
        new_done = done | impact | (new_t > max_t)
        t = torch.where(new_done, t, new_t)
        done = new_done
        if t.device.type == "cpu" and bool(done.all()):
            break  # nothing changes any more (done is absorbing); the card never reads it
    return hit_t


# K8's per-record floats, in its layout (csrc/conservative_advance.cu).
_F_FIELDS = (("sweep", "pos"), ("sweep", "orn"), ("sweep", "vel"), ("sweep", "omega"),
             ("o_pos",), ("o_orn",), ("o_vel",), ("o_omega",), ("lpos",), ("lorn",))
_P, _I = ctypes.c_void_p, ctypes.c_int
_K8_ARGS = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P]


def _shared_rows(t):
    """(contiguous rows, row stride): one row and stride 0 where every record shares it
    (an expanded tensor), else the rows themselves."""
    if t.shape[0] > 1 and t.stride(0) == 0:
        return t[0].contiguous(), 0
    return t.contiguous(), t.shape[1]


def conservative_advance(x, iters: int = SWEEP_ITERS, miss_max_t: bool = False, work=None):
    """Kernel K8: ``_advance(x, (), iters, miss_max_t)`` for records of the built-in
    convex types (sphere, capsule, box, cylinder, triangle, convex hull). ``x`` (n
    records): ``sweep`` {pos, orn, vel, omega} and ``o_pos``, ``o_orn``, ``o_vel``,
    ``o_omega`` the two bodies' poses and velocities at t = 0, ``lpos`` / ``lorn`` the
    target's pose in its owner's frame, ``type_a`` / ``type_b`` (n,) int32, ``params_a``
    / ``params_b`` (n, 12), ``hull_points`` the registry's pool, ``hull_a`` / ``hull_b``
    (n, H) pool rows, ``speed_bound``, ``exists`` and ``max_t`` (n,). A-side rows may be
    one row expanded over the records. On a CUDA tensor it launches K8 (counted in
    ``conservative_advance.launches``); on a CPU tensor it runs the plain version.
    ``work`` (card only): an (n, 2) int32 tensor that K8 fills with each record's
    advancement and GJK iterations."""
    speed_bound = x["speed_bound"]
    dev = speed_bound.device
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"conservative_advance runs on cuda or cpu, not {dev.type}")
        return _advance(x, (), iters, miss_max_t)
    n = speed_bound.shape[0]
    f32 = torch.float32
    cols = [c for path in _F_FIELDS for c in _field(x, path)]
    f = torch.stack([c.to(f32) for c in cols] + [speed_bound.to(f32), x["max_t"].to(f32)], -1)
    ti = torch.stack([x["type_a"].to(torch.int32), x["type_b"].to(torch.int32),
                      x["exists"].to(torch.int32)], -1)
    params_a, pa_stride = _shared_rows(x["params_a"].to(f32))
    params_b = x["params_b"].to(f32).contiguous()
    hull_a, ha_stride = _shared_rows(x["hull_a"].to(torch.int32))
    hull_b = x["hull_b"].to(torch.int32).contiguous()
    hx, hy, hz = (c.to(f32).contiguous() for c in x["hull_points"])
    width = hull_b.shape[1]
    if params_b.shape != (n, 12) or hull_b.shape[0] != n or hull_a.shape[-1] != width:
        raise ValueError(f"conservative_advance: params_b {tuple(params_b.shape)}, hull_a "
                         f"{tuple(hull_a.shape)}, hull_b {tuple(hull_b.shape)} for {n} records")
    for name, t in (("f", f), ("params_a", params_a), ("hull_a", hull_a), ("hull_x", hx)):
        if t.device != dev:
            raise ValueError(f"conservative_advance: {name} is on {t.device}, expected {dev}")
    if work is not None and (work.shape != (n, 2) or work.dtype != torch.int32
                             or work.device != dev or not work.is_contiguous()):
        raise ValueError(f"conservative_advance: work must be ({n}, 2) int32 on {dev}")
    out = torch.empty(n, dtype=f32, device=dev)
    launch = build.bind("conservative_advance", "conservative_advance_launch", _K8_ARGS)
    err = launch(f.data_ptr(), ti.data_ptr(), params_a.data_ptr(), pa_stride,
                 params_b.data_ptr(), hx.data_ptr(), hy.data_ptr(), hz.data_ptr(),
                 hull_a.data_ptr(), ha_stride, hull_b.data_ptr(), width, n, iters,
                 int(miss_max_t), out.data_ptr(), None if work is None else work.data_ptr(),
                 build.raw_stream(dev))
    if err:
        raise RuntimeError(f"conservative_advance kernel launch failed: CUDA error {err}")
    conservative_advance.launches += 1
    return out


conservative_advance.launches = 0


def _field(x, path):
    v = x
    for k in path:
        v = v[k]
    return v


def advance(x, custom_ids, iters: int = SWEEP_ITERS, miss_max_t: bool = False):
    """The advancement of every record (``conservative_advance``'s ``x``). ``custom_ids``
    (a tuple): the custom shape types that may occur in the records, decided on the host
    from the types present. Without one, K8 (or its plain version on the CPU); with one,
    the masked loop in PyTorch ops, replayed as a CUDA graph on the card."""
    if not custom_ids:
        return conservative_advance(x, iters, miss_max_t)
    fns = tuple(CUSTOM_SUPPORTS[t] for t in custom_ids)
    return replay.run(("advance", iters, miss_max_t, custom_ids, fns),
                      lambda d: _advance(d, custom_ids, iters, miss_max_t), x)


def sweep_shape_all(
    state: BodyState,
    shapes: ShapeData,
    shape_type: int,
    shape_params,  # (12,) packed params of the swept shape
    shape_row: int,  # its registry row for the hull pool (-1 if none)
    pos: Vec3,
    orn: Quat,
    vel: Vec3,
    omega: Vec3,
    sweep_radius,  # the swept shape's maximum radius (the angular bound)
    max_t,
    child_owner=None,  # (K,) body slot of each compound / mesh child target (-1 = pad)
    child_rows=None,  # (K,) its child-pool row
    prune_k: int = 0,
    custom_ids=None,  # the custom shape types to evaluate (None: every registered one)
) -> SweepHit:
    """Time of impact of the swept shape against every collidable, reduced to the least.
    ``pos``, ``orn``, ``vel`` and ``omega`` have scalar components (one sweep) or (R,)
    components (a batch of R sweeps). ``prune_k`` > 0: a centre-gap bound on each
    target's entry time ranks the targets, and only the ``prune_k`` earliest (a stable
    sort, ties to the lower target, as ``lax.top_k``) are advanced."""
    n = state.pos.x.shape[0]
    dev = state.pos.x.device
    batched = pos.x.dim() > 0
    if not batched:
        pos, orn, vel, omega = pos[None], orn[None], vel[None], omega[None]
    n_sweeps = pos.x.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    max_t = torch.as_tensor(max_t, **f32)
    sweep_radius = torch.as_tensor(sweep_radius, **f32)

    tgt_shape = state.shape.clamp_min(0).long()
    tgt_type = torch.where(state.shape >= 0, shapes.type[tgt_shape], -1)
    is_comp = (tgt_type == COMPOUND) | (tgt_type == MESH) | (tgt_type == BIG_COMPOUND)

    # Unified targets: the bodies, then the child targets.
    tg_owner = torch.arange(n, device=dev)
    tg_type = tgt_type
    tg_params = shapes.params[tgt_shape]
    tg_hull = shapes.hull_rows[tgt_shape]
    tg_radius = shapes.max_radius[tgt_shape]
    tg_exists = state.exists & (state.shape >= 0) & ~is_comp
    zero = torch.zeros(n, **f32)
    tg_lpos = Vec3(zero, zero, zero)
    tg_lorn = Quat(zero, zero, zero, torch.ones(n, **f32))
    if child_owner is not None and child_owner.shape[0] > 0:
        co = child_owner.long()
        cr = child_rows.clamp_min(0).long()
        cs = shapes.child_shape[cr]
        is_tri = cs < 0
        cs_c = cs.clamp_min(0).long()
        cp, cq = shapes.child_pos[cr], shapes.child_orn[cr]
        # The rotational lever arm: the child AABB's farthest corner from the owner.
        far = torch.maximum(shapes.child_aabb_min[cr].abs(), shapes.child_aabb_max[cr].abs())
        tg_owner = torch.cat([tg_owner, co.clamp_min(0)])
        tg_type = torch.cat([tg_type, torch.where(is_tri, TRIANGLE, shapes.type[cs_c])])
        tri12 = torch.nn.functional.pad(shapes.child_tri[cr], (0, 3))
        tg_params = torch.cat([tg_params,
                               torch.where(is_tri[:, None], tri12, shapes.params[cs_c])])
        tg_hull = torch.cat([tg_hull, torch.where(is_tri[:, None], -1, shapes.hull_rows[cs_c])])
        tg_radius = torch.cat([tg_radius, torch.sqrt(far[:, 0] ** 2 + far[:, 1] ** 2
                                                     + far[:, 2] ** 2)])
        tg_exists = torch.cat([tg_exists, (co >= 0) & state.exists[co.clamp_min(0)]])
        tg_lpos = Vec3(*(torch.cat([a, b]) for a, b in zip(tg_lpos, (cp[:, 0], cp[:, 1],
                                                                     cp[:, 2]))))
        tg_lorn = Quat(*(torch.cat([a, cq[:, i]]) for i, a in enumerate(tg_lorn)))

    # Every target per sweep: (R, T) by broadcasting, or (R, K) after the prune.
    o_pos, o_orn = state.pos[tg_owner], state.orn[tg_owner]
    o_vel, o_omega = state.vel[tg_owner], state.omega[tg_owner]
    row = lambda v: type(v)(*(c[:, None] for c in v))
    a_pos, a_orn, a_vel, a_omega = row(pos), row(orn), row(vel), row(omega)
    n_tg = tg_owner.shape[0]
    saturated = None
    expand = lambda x: x.expand(n_sweeps, *x.shape)
    if prune_k and prune_k < n_tg:
        b0 = o_pos + o_orn.rotate(tg_lpos)
        gap = (b0 - a_pos).length() - tg_radius - sweep_radius
        sb_ = ((a_vel - o_vel).length() + a_omega.length() * sweep_radius
               + o_omega.length() * tg_radius + 1e-6)
        entry = gap.clamp_min(0.0) / sb_
        entry = torch.where(tg_exists & (entry <= max_t), entry, _INF)
        ranked = torch.sort(entry, dim=-1, stable=True)
        sel = ranked.indices[:, :prune_k]
        kth = ranked.values[:, prune_k - 1]
        kth_live = kth < _INF
        pick = lambda v: type(v)(*(c[sel] for c in v)) if not torch.is_tensor(v) else v[sel]
        tg_owner, tg_type, tg_params, tg_hull, tg_radius = (
            pick(tg_owner), pick(tg_type), pick(tg_params), pick(tg_hull), pick(tg_radius))
        tg_lpos, tg_lorn = pick(tg_lpos), pick(tg_lorn)
        o_pos, o_orn, o_vel, o_omega = pick(o_pos), pick(o_orn), pick(o_vel), pick(o_omega)
        tg_exists = ranked.values[:, :prune_k] < _INF
        n_tg = prune_k
        saturated = kth_live, kth
    else:
        tg_owner, tg_type, tg_params, tg_hull, tg_radius, tg_exists = (
            expand(tg_owner), expand(tg_type), expand(tg_params), expand(tg_hull),
            expand(tg_radius), expand(tg_exists))
        tg_lpos, tg_lorn, o_pos, o_orn, o_vel, o_omega = (
            type(v)(*(expand(c) for c in v))
            for v in (tg_lpos, tg_lorn, o_pos, o_orn, o_vel, o_omega))

    # Flatten to (R·T,) records; the swept shape is the A side of every record.
    n_rec = n_sweeps * n_tg
    flat = lambda v: (v.reshape(n_rec, *v.shape[2:]) if torch.is_tensor(v)
                      else type(v)(*(c.expand(n_sweeps, n_tg).reshape(n_rec) for c in v)))
    rel_v = a_vel - o_vel
    speed_bound = (rel_v.length() + a_omega.length() * sweep_radius
                   + o_omega.length() * tg_radius + 1e-6)
    params_a = torch.as_tensor(shape_params, **f32)
    hull_a = (shapes.hull_rows[shape_row] if shape_row >= 0
              else torch.full_like(shapes.hull_rows[0], -1))
    inputs = dict(
        sweep=dict(pos=flat(a_pos), orn=flat(a_orn), vel=flat(a_vel), omega=flat(a_omega)),
        type_a=torch.full((n_rec,), shape_type, dtype=torch.int32, device=dev),
        params_a=params_a.expand(n_rec, params_a.shape[0]), type_b=flat(tg_type),
        params_b=flat(tg_params), hull_points=Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z),
        hull_a=hull_a.expand(n_rec, hull_a.shape[0]), hull_b=flat(tg_hull),
        o_pos=flat(o_pos), o_orn=flat(o_orn), o_vel=flat(o_vel), o_omega=flat(o_omega),
        lpos=flat(tg_lpos), lorn=flat(tg_lorn),
        speed_bound=flat(speed_bound.expand(n_sweeps, n_tg)), exists=flat(tg_exists),
        max_t=max_t.expand(n_rec),
    )
    custom = tuple(CUSTOM_SUPPORTS) if custom_ids is None else tuple(custom_ids)
    hit_t = advance(inputs, custom, SWEEP_ITERS)
    hit_t = hit_t.reshape(n_sweeps, n_tg)

    best = torch.argmin(hit_t, dim=-1)
    best_t = hit_t.gather(-1, best[:, None])[:, 0]
    found = best_t < _INF
    sat_out = None
    if saturated is not None:
        kth_live, kth = saturated
        sat_out = kth_live & (kth <= torch.minimum(best_t, max_t))
    owner = tg_owner.gather(-1, best[:, None])[:, 0]
    out = SweepHit(
        hit=found,
        t=torch.where(found, best_t, max_t),
        body=torch.where(found, owner, -1).to(torch.int32),
        saturated=sat_out,
    )
    if not batched:
        out = SweepHit(out.hit[0], out.t[0], out.body[0],
                       None if sat_out is None else sat_out[0])
    return out


def _is_composite(t):
    return (t == COMPOUND) | (t == MESH) | (t == BIG_COMPOUND)


def pair_toi(state: BodyState, shapes: ShapeData, a, b, live, max_t, iters: int = 12,
             max_children: int = 8, composites: bool = True, custom_ids=()):
    """Conservative-advancement time of impact of body pairs (a[i], b[i]), the CCD sweep
    (reference NarrowPhaseCCDContinuations, ConvexSweepTaskCommon) over the compacted CCD
    pair set: (n,) t in [0, max_t], max_t where a pair meets nothing within the step.

    A pair with one compound or mesh body puts it on side B and sweeps against its
    children (reference ConvexCompoundSweepTask): the clustered child selection of the
    narrow phase (``compound._select_children_clustered``) queried with the sweep-inflated
    bounding sphere, the least t over the picked children. Two composites keep the
    body-level bound. ``composites`` False: the host knows no body is a compound or a
    mesh, and the child pass, which could then only find nothing, is left out.
    ``custom_ids``: the custom shape types present (``advance``)."""
    from .compound import _select_children_clustered

    a, b = a.long(), b.long()
    type_of = lambda body: torch.where(state.shape[body] >= 0,
                                       shapes.type[state.shape[body].clamp_min(0).long()], -1)
    # Canonical: if A is the only composite, swap it onto B.
    swap = _is_composite(type_of(a)) & ~_is_composite(type_of(b))
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    sa = state.shape[a].clamp_min(0).long()
    sb = state.shape[b].clamp_min(0).long()
    type_a, type_b = type_of(a), type_of(b)
    comp_pair = _is_composite(type_b) & ~_is_composite(type_a)
    ra, rb = shapes.max_radius[sa], shapes.max_radius[sb]
    pos_a0, pos_b0 = state.pos[a], state.pos[b]
    orn_a0, orn_b0 = state.orn[a], state.orn[b]
    vel_a, vel_b = state.vel[a], state.vel[b]
    om_a, om_b = state.omega[a], state.omega[b]
    speed_bound = (vel_a - vel_b).length() + om_a.length() * ra + om_b.length() * rb + 1e-6
    n = a.shape[0]
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    hull_points = Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z)
    zero = torch.zeros(n, **f32)
    body = dict(
        sweep=dict(pos=pos_a0, orn=orn_a0, vel=vel_a, omega=om_a),
        type_a=type_a.to(torch.int32), params_a=shapes.params[sa], type_b=type_b.to(torch.int32),
        params_b=shapes.params[sb], hull_points=hull_points, hull_a=shapes.hull_rows[sa],
        hull_b=shapes.hull_rows[sb], o_pos=pos_b0, o_orn=orn_b0, o_vel=vel_b, o_omega=om_b,
        lpos=Vec3(zero, zero, zero), lorn=Quat(zero, zero, zero, torch.ones(n, **f32)),
        speed_bound=speed_bound, exists=live & ~comp_pair, max_t=torch.full((n,), max_t, **f32))
    hit_body = advance(body, custom_ids, iters, miss_max_t=True)

    if max_children > 0 and composites:
        # Child-level sweeps of the convex-vs-compound and convex-vs-mesh pairs.
        n_pick = max(1, -(-max_children // ShapeRegistry.CLUSTER_SIZE))
        rel_pos_local = orn_b0.rotate_inverse(pos_a0 - pos_b0)
        qrad = (ra + (vel_a - vel_b).length() * max_t
                + (om_a.length() + om_b.length()) * (ra + rb) * max_t)
        rows, cand_ok, _ = _select_children_clustered(shapes, sb, rel_pos_local, qrad, n_pick)
        k = rows.shape[1]
        cr = rows.clamp_min(0).long()
        cshape = shapes.child_shape[cr]
        is_tri = cshape < 0
        cs_c = cshape.clamp_min(0).long()
        tri12 = torch.nn.functional.pad(shapes.child_tri[cr], (0, 3))
        cparams = torch.where(is_tri[..., None], tri12, shapes.params[cs_c])
        cp, cq = shapes.child_pos[cr], shapes.child_orn[cr]
        live_child = comp_pair[:, None] & live[:, None] & cand_ok & (rows >= 0)
        flat = lambda v: (v[:, None].expand(n, k).reshape(-1) if torch.is_tensor(v)
                          else type(v)(*(flat(c) for c in v)))
        fsa = flat(sa)
        child = dict(
            sweep=dict(pos=flat(pos_a0), orn=flat(orn_a0), vel=flat(vel_a), omega=flat(om_a)),
            type_a=flat(type_a).to(torch.int32), params_a=shapes.params[fsa],
            type_b=torch.where(is_tri, TRIANGLE, shapes.type[cs_c]).reshape(-1).to(torch.int32),
            params_b=cparams.reshape(n * k, -1), hull_points=hull_points,
            hull_a=shapes.hull_rows[fsa],
            hull_b=torch.where(is_tri[..., None], -1, shapes.hull_rows[cs_c]).reshape(n * k, -1),
            o_pos=flat(pos_b0), o_orn=flat(orn_b0), o_vel=flat(vel_b), o_omega=flat(om_b),
            lpos=Vec3(*(cp[..., i].reshape(-1) for i in range(3))),
            lorn=Quat(*(cq[..., i].reshape(-1) for i in range(4))),
            speed_bound=flat(speed_bound), exists=live_child.reshape(-1),
            max_t=torch.full((n * k,), max_t, **f32))
        hit_child = advance(child, custom_ids, iters, miss_max_t=True).reshape(n, k).amin(1)
        hit_body = torch.where(comp_pair, hit_child, hit_body)

    return torch.where(live, hit_body.clamp_max(max_t), max_t)
