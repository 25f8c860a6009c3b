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
(``csrc/conservative_advance.cu``, ``conservative_advance``) over factored records: an A
table of the swept sides and a B table of the targets, each row once, and either their
product (a sweep batch against every target) or an explicit (A row, B row) list (a
pruned sweep, CCD's pairs). A registered custom shape's support is a Python function,
which no kernel can call: where one may occur (decided on the host from the types
present) the masked loop runs as PyTorch ops over the gathered records instead, replayed
as one CUDA graph per layout on the card (``utils/replay.py``).
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
    ``miss_max_t``). ``x`` holds flat per-record tensors (``gather_records``). The loop
    of K8's plain version (``conservative_advance_plain``)."""
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


# K8's tables (csrc/conservative_advance.cu): the float rows of a (C, rows) table.
A_COLS = 26  # position 0-2, orientation 3-6, velocity 7-9, angular velocity 10-12,
#              the radius of the speed bound 13, packed params 14-25
B_COLS = 33  # and the target's pose in its owner's frame: position 26-28, orientation 29-32
# The int rows: type, registry row into ``hull_rows`` (-1: none), exists.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_K8_ARGS = [_P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _F, _I, _I, _P, _P, _P,
            _P, _I, _P]


class Table(NamedTuple):
    """One side of K8's records, structure-of-arrays: ``f`` (A_COLS or B_COLS, rows)
    float32, ``i`` (3, rows) int32."""
    f: torch.Tensor
    i: torch.Tensor

    @property
    def rows(self) -> int:
        return self.f.shape[1]


def table(pos: Vec3, orn: Quat, vel: Vec3, omega: Vec3, radius, type_, params, hull_row,
          exists=None, lpos: Vec3 = None, lorn: Quat = None) -> Table:
    """A table of (rows,) columns (a number, or a tensor that broadcasts): the pose and
    velocity, the radius of the speed bound, the type, ``params`` (rows or 1, 12), the
    registry row into ``hull_rows`` (-1: none) and ``exists`` (default all); with ``lpos``
    / ``lorn`` a B table (the target's pose in its owner's frame), else an A table. A
    number becomes a filled column, never a copy from the host."""
    rows = pos.x.shape[0]
    dev = pos.x.device

    def col(c, dtype):
        if torch.is_tensor(c):
            return c.to(dtype).expand(rows)
        return torch.full((rows,), c, dtype=dtype, device=dev)

    f32 = torch.float32
    parts = [torch.stack([col(c, f32) for c in (*pos, *orn, *vel, *omega, radius)]),
             params.to(f32).expand(rows, 12).T]
    if lpos is not None:
        parts.append(torch.stack([col(c, f32) for c in (*lpos, *lorn)]))
    i = torch.stack([col(c, torch.int32) for c in (type_, hull_row,
                                                   1 if exists is None else exists)])
    return Table(torch.cat(parts), i)


class Records(NamedTuple):
    """K8's records over two tables. ``pairs`` None: every A row against every B row,
    A-major (record r = (r // b.rows, r % b.rows)), each with B's ``exists``; else (n, 2)
    int32 (A row, B row) with ``exists`` (n,) bool. ``hull_rows`` (S, H) int32 and
    ``hull_points`` the registry's hull pool; ``max_t`` a float."""
    a: Table
    b: Table
    pairs: torch.Tensor
    exists: torch.Tensor
    max_t: float
    hull_rows: torch.Tensor
    hull_points: Vec3

    @property
    def n(self) -> int:
        if self.pairs is None:
            return self.a.rows * self.b.rows
        return self.pairs.shape[0]


def gather_records(rec: Records):
    """The flat per-record tensors ``_advance`` takes, gathered from the tables, with the
    speed bound |v_a - v_b| + |w_a| r_a + |w_b| r_b + 1e-6 (the order K8 computes it in)."""
    dev = rec.a.f.device
    if rec.pairs is None:
        r = torch.arange(rec.n, device=dev)
        ia, ib = r // rec.b.rows, r % rec.b.rows
        exists = rec.b.i[2, ib] != 0
    else:
        ia, ib = rec.pairs[:, 0].long(), rec.pairs[:, 1].long()
        exists = rec.exists.bool()
    fa, fb = rec.a.f[:, ia], rec.b.f[:, ib]
    v = lambda f, c: Vec3(f[c], f[c + 1], f[c + 2])
    q = lambda f, c: Quat(f[c], f[c + 1], f[c + 2], f[c + 3])
    hull = lambda row: torch.where((row >= 0)[:, None],
                                   rec.hull_rows[row.clamp_min(0).long()], -1)
    a_vel, a_omega, o_vel, o_omega = v(fa, 7), v(fa, 10), v(fb, 7), v(fb, 10)
    speed_bound = ((a_vel - o_vel).length() + a_omega.length() * fa[13]
                   + o_omega.length() * fb[13] + 1e-6)
    return dict(
        sweep=dict(pos=v(fa, 0), orn=q(fa, 3), vel=a_vel, omega=a_omega),
        type_a=rec.a.i[0, ia], params_a=fa[14:26].T, type_b=rec.b.i[0, ib],
        params_b=fb[14:26].T, hull_points=rec.hull_points, hull_a=hull(rec.a.i[1, ia]),
        hull_b=hull(rec.b.i[1, ib]), o_pos=v(fb, 0), o_orn=q(fb, 3), o_vel=o_vel,
        o_omega=o_omega, lpos=v(fb, 26), lorn=q(fb, 29), speed_bound=speed_bound,
        exists=exists, max_t=torch.full((rec.n,), rec.max_t, dtype=torch.float32, device=dev))


def conservative_advance_plain(rec: Records, iters: int = SWEEP_ITERS,
                               miss_max_t: bool = False):
    """K8's plain version: the flat records gathered from the tables, then ``_advance``."""
    return _advance(gather_records(rec), (), iters, miss_max_t)


def conservative_advance(rec: Records, iters: int = SWEEP_ITERS, miss_max_t: bool = False,
                         work=None, counters=None):
    """Kernel K8: ``conservative_advance_plain(rec, iters, miss_max_t)`` for records of the
    built-in convex types (sphere, capsule, box, cylinder, triangle, convex hull): (n,)
    time of impact, or the miss value. On a CUDA tensor it launches K8's two passes, one
    call counted in ``conservative_advance.launches``; on a CPU tensor it runs the plain
    version. Card only: ``work``, an (n, 2) int32 tensor that K8 fills with each record's
    advancement and GJK iterations; ``counters``, a (2,) int32 tensor K8 takes for its
    queue's length (the records pass 1 left to pass 2) and head."""
    dev = rec.a.f.device
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"conservative_advance runs on cuda or cpu, not {dev.type}")
        return conservative_advance_plain(rec, iters, miss_max_t)
    n = rec.n
    f32, i32 = torch.float32, torch.int32
    a, b = rec.a, rec.b
    hx, hy, hz = rec.hull_points
    checks = [("a.f", a.f, f32, (A_COLS, a.rows)), ("a.i", a.i, i32, (3, a.rows)),
              ("b.f", b.f, f32, (B_COLS, b.rows)), ("b.i", b.i, i32, (3, b.rows)),
              ("hull_rows", rec.hull_rows, i32, rec.hull_rows.shape),
              ("hull_x", hx, f32, hx.shape), ("hull_y", hy, f32, hx.shape),
              ("hull_z", hz, f32, hx.shape)]
    if a.f.shape[0] == B_COLS:  # a B table may serve as the A side
        checks[0] = ("a.f", a.f, f32, (B_COLS, a.rows))
    if rec.pairs is not None:
        checks += [("pairs", rec.pairs, i32, (n, 2)), ("exists", rec.exists, torch.bool, (n,))]
    elif n >= 2 ** 31:
        raise ValueError(f"conservative_advance: {n} records in the product form")
    if work is not None:
        checks.append(("work", work, i32, (n, 2)))
    if counters is None:
        counters = torch.empty(2, dtype=i32, device=dev)
    checks.append(("counters", counters, i32, (2,)))
    for name, t, dtype, shape in checks:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"conservative_advance: {name} must be {tuple(shape)} {dtype}, "
                             f"contiguous, on {dev}; got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    out = torch.empty(n, dtype=f32, device=dev)
    queue = torch.empty(n, 2, dtype=i32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    launch = build.bind("conservative_advance", "conservative_advance_launch", _K8_ARGS)
    err = launch(a.f.data_ptr(), a.i.data_ptr(), a.rows, b.f.data_ptr(), b.i.data_ptr(),
                 b.rows, ptr(rec.pairs), ptr(rec.exists), n, rec.hull_rows.data_ptr(),
                 rec.hull_rows.shape[1], hx.data_ptr(), hy.data_ptr(), hz.data_ptr(),
                 rec.max_t, iters, int(miss_max_t), out.data_ptr(), ptr(work),
                 queue.data_ptr(), counters.data_ptr(), 3, build.raw_stream(dev))
    if err:
        raise RuntimeError(f"conservative_advance kernel launch failed: CUDA error {err}")
    conservative_advance.launches += 1
    return out


conservative_advance.launches = 0


def advance(rec: Records, custom_ids, iters: int = SWEEP_ITERS, miss_max_t: bool = False):
    """The advancement of every record (``conservative_advance``'s ``rec``).
    ``custom_ids`` (a tuple): the custom shape types that may occur in the records,
    decided on the host from the types present. Without one, K8 (or its plain version on
    the CPU); with one, the masked loop in PyTorch ops over the gathered records, replayed
    as a CUDA graph on the card."""
    if not custom_ids:
        return conservative_advance(rec, iters, miss_max_t)
    fns = tuple(CUSTOM_SUPPORTS[t] for t in custom_ids)
    return replay.run(("advance", iters, miss_max_t, custom_ids, fns),
                      lambda d: _advance(d, custom_ids, iters, miss_max_t),
                      gather_records(rec))


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
    max_t_f = float(max_t)
    max_t = torch.as_tensor(max_t, **f32)
    sweep_radius = torch.as_tensor(sweep_radius, **f32)

    tgt_shape = state.shape.clamp_min(0).long()
    tgt_type = torch.where(state.shape >= 0, shapes.type[tgt_shape], -1)
    is_comp = (tgt_type == COMPOUND) | (tgt_type == MESH) | (tgt_type == BIG_COMPOUND)

    # Unified targets: the bodies, then the child targets.
    tg_owner = torch.arange(n, device=dev)
    tg_type = tgt_type
    tg_params = shapes.params[tgt_shape]
    tg_row = tgt_shape
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
        tg_row = torch.cat([tg_row, torch.where(is_tri, -1, cs_c)])
        tg_radius = torch.cat([tg_radius, torch.sqrt(far[:, 0] ** 2 + far[:, 1] ** 2
                                                     + far[:, 2] ** 2)])
        tg_exists = torch.cat([tg_exists, (co >= 0) & state.exists[co.clamp_min(0)]])
        tg_lpos = Vec3(*(torch.cat([a, b]) for a, b in zip(tg_lpos, (cp[:, 0], cp[:, 1],
                                                                     cp[:, 2]))))
        tg_lorn = Quat(*(torch.cat([a, cq[:, i]]) for i, a in enumerate(tg_lorn)))

    # The tables: the R sweeps (A) and the T targets (B), each row once.
    o_pos, o_orn = state.pos[tg_owner], state.orn[tg_owner]
    o_vel, o_omega = state.vel[tg_owner], state.omega[tg_owner]
    targets = table(o_pos, o_orn, o_vel, o_omega, tg_radius, tg_type, tg_params, tg_row,
                    tg_exists, tg_lpos, tg_lorn)
    swept = table(pos, orn, vel, omega, sweep_radius, shape_type,
                  torch.as_tensor(shape_params, **f32)[None], shape_row)
    n_tg = tg_owner.shape[0]
    pairs = exists = saturated = None
    owners = tg_owner.expand(n_sweeps, n_tg)
    if prune_k and prune_k < n_tg:
        row = lambda v: type(v)(*(c[:, None] for c in v))
        a_pos, a_vel, a_omega = row(pos), row(vel), row(omega)
        b0 = o_pos + o_orn.rotate(tg_lpos)
        gap = (b0 - a_pos).length() - tg_radius - sweep_radius
        sb_ = ((a_vel - o_vel).length() + a_omega.length() * sweep_radius
               + o_omega.length() * tg_radius + 1e-6)
        entry = gap.clamp_min(0.0) / sb_
        entry = torch.where(tg_exists & (entry <= max_t), entry, _INF)
        ranked = torch.sort(entry, dim=-1, stable=True)
        sel = ranked.indices[:, :prune_k]
        kth = ranked.values[:, prune_k - 1]
        # The (R, K) records: each sweep's K earliest targets.
        sweep_rows = torch.arange(n_sweeps, device=dev)[:, None].expand(n_sweeps, prune_k)
        pairs = torch.stack([sweep_rows, sel], -1).reshape(-1, 2).to(torch.int32)
        exists = (ranked.values[:, :prune_k] < _INF).reshape(-1)
        owners = tg_owner[sel]
        saturated = kth < _INF, kth
    rec = Records(swept, targets, pairs, exists, max_t_f, shapes.hull_rows,
                  Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z))
    custom = tuple(CUSTOM_SUPPORTS) if custom_ids is None else tuple(custom_ids)
    hit_t = advance(rec, custom, SWEEP_ITERS).reshape(n_sweeps, -1)

    best = torch.argmin(hit_t, dim=-1)
    best_t = hit_t.gather(-1, best[:, None])[:, 0]
    found = best_t < _INF
    sat_out = None
    if saturated is not None:
        kth_live, kth = saturated
        sat_out = kth_live & (kth <= torch.minimum(best_t, max_t))
    owner = owners.gather(-1, best[:, None])[:, 0]
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
    n_bodies = state.pos.x.shape[0]
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    shape = state.shape.clamp_min(0).long()
    btype = torch.where(state.shape >= 0, shapes.type[shape], -1)
    # Canonical: if A is the only composite, swap it onto B.
    swap = _is_composite(btype[a]) & ~_is_composite(btype[b])
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    sb = shape[b]
    type_a, type_b = btype[a], btype[b]
    comp_pair = _is_composite(type_b) & ~_is_composite(type_a)
    ra, rb = shapes.max_radius[shape[a]], shapes.max_radius[sb]
    pos_a0, pos_b0 = state.pos[a], state.pos[b]
    orn_b0 = state.orn[b]
    vel_a, vel_b = state.vel[a], state.vel[b]
    om_a, om_b = state.omega[a], state.omega[b]
    n = a.shape[0]
    hull_points = Vec3(shapes.hull_x, shapes.hull_y, shapes.hull_z)
    # Every body once, the A side of both levels and the B side of the body level.
    zero = torch.zeros(n_bodies, **f32)
    bodies = table(state.pos, state.orn, state.vel, state.omega, shapes.max_radius[shape],
                   btype, shapes.params[shape], shape, None, Vec3(zero, zero, zero),
                   Quat(zero, zero, zero, torch.ones(n_bodies, **f32)))
    max_t_f = float(max_t)
    body = Records(bodies, bodies, torch.stack([a, b], -1).to(torch.int32), live & ~comp_pair,
                   max_t_f, shapes.hull_rows, hull_points)
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
        # One B row per (pair, candidate child): the owner's motion, the child's pose.
        children = table(
            flat(pos_b0), flat(orn_b0), flat(vel_b), flat(om_b), flat(rb),
            torch.where(is_tri, TRIANGLE, shapes.type[cs_c]).reshape(-1),
            cparams.reshape(n * k, -1), torch.where(is_tri, -1, cs_c).reshape(-1), None,
            Vec3(*(cp[..., i].reshape(-1) for i in range(3))),
            Quat(*(cq[..., i].reshape(-1) for i in range(4))))
        pairs = torch.stack([flat(a), torch.arange(n * k, device=dev)], -1).to(torch.int32)
        child = Records(bodies, children, pairs, live_child.reshape(-1), max_t_f,
                        shapes.hull_rows, hull_points)
        hit_child = advance(child, custom_ids, iters, miss_max_t=True).reshape(n, k).amin(1)
        hit_body = torch.where(comp_pair, hit_child, hit_body)

    return torch.where(live, hit_body.clamp_max(max_t), max_t)
