"""Shape sweeps: time of impact by conservative advancement against every collidable,
then a min-t reduction.

Counterpart of ``sweep_shape_all`` in ``bepuphysics2_tpu/collision/sweeps.py`` (reference
SweepTasks/ConvexSweepTaskCommon.cs:116-230, Simulation_Queries.cs:267): ``SWEEP_ITERS``
fixed iterations of

    d <- GJK distance between the shapes posed at time t
    done if d < 1e-4 (impact) or t > max_t (miss)
    t <- t + d / (a bound on the approach speed)

over every target at once, with the port's own ``convex.gjk_closest``. Targets are
(owner body, local pose, convex shape): each plain body, and each child of a compound or
mesh body (the host enumerates them), the compound itself left out. A batch of R sweeps
is one pass over (R, T) records, not R calls. On a CUDA device the 32 iterations replay
as one CUDA graph per batch layout (``utils/replay.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bodies import BodyState
from ..shapes.registry import BIG_COMPOUND, COMPOUND, MESH, TRIANGLE, ShapeData
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


def _advance(x, shape_type, custom_ids):
    """The conservative advancement of every record: (R·T,) time of impact, _INF where
    none within max_t. ``x`` holds flat per-record tensors."""
    sa = x["sweep"]
    n_rec = sa["pos"].x.shape[0]
    ctx0 = SupportCtx(
        type_a=torch.full((n_rec,), shape_type, dtype=torch.int32, device=sa["pos"].x.device),
        params_a=x["params_a"], type_b=x["type_b"], params_b=x["params_b"], orn_ab=None,
        pos_ab=None, hull_points=x["hull_points"], hull_rows_a=x["hull_a"],
        hull_rows_b=x["hull_b"], custom_ids=custom_ids)

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
    hit_t = torch.full_like(speed_bound, _INF)
    for _ in range(SWEEP_ITERS):
        dist, _, _, margin = gjk_closest(ctx_at(t))
        dist = dist - margin  # the surface distance, radii included
        impact = dist < 1e-4
        hit_t = torch.where(impact & ~done, t, hit_t)
        new_t = t + torch.clamp_min(dist.clamp_min(0.0) / speed_bound, 1e-5)
        new_done = done | impact | (new_t > max_t)
        t = torch.where(new_done, t, new_t)
        done = new_done
    return torch.where(x["exists"], hit_t, _INF)


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
        params_a=params_a.expand(n_rec, params_a.shape[0]), type_b=flat(tg_type),
        params_b=flat(tg_params), hull_points=Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z),
        hull_a=hull_a.expand(n_rec, hull_a.shape[0]), hull_b=flat(tg_hull),
        o_pos=flat(o_pos), o_orn=flat(o_orn), o_vel=flat(o_vel), o_omega=flat(o_omega),
        lpos=flat(tg_lpos), lorn=flat(tg_lorn),
        speed_bound=flat(speed_bound.expand(n_sweeps, n_tg)), exists=flat(tg_exists),
        max_t=max_t.expand(n_rec),
    )
    custom = None if custom_ids is None else tuple(custom_ids)
    hit_t = replay.run(("sweep_shape_all", shape_type, custom),
                       lambda x: _advance(x, shape_type, custom), inputs)
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
