"""Compound narrow phase: bounded child-pair expansion.

Counterpart of ``ChildPairs`` and ``expand_compound_pairs`` in
``bepuphysics2_tpu/collision/compound.py`` (reference
CollisionTasks/ConvexCompoundCollisionTask.cs, ConvexCompoundOverlapFinder.cs): broad-phase
pairs touching a compound are compacted into ``max_compound_pairs`` slots; each slot
expands into ``children_per_pair`` child records, picked by a cluster-then-child AABB
prefilter in the compound's frame (nearest overlapping children first, then re-sorted by
child row so slots stay stable across frames). Every child record becomes its own
contact record, keyed for warm starting by its slot. Meshes count as compounds: their
children are triangles. Compound-vs-compound (and compound-vs-mesh) pairs expand through
``expand_compound_compound`` into children_per_side² records (reference
CompoundPairCollisionTask.cs, CompoundMeshReduction.cs), or raise the overflow flag where
that expansion is off. Every sort is stable, as the JAX package's are, so the layouts
agree exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bodies import BodyState
from ..shapes.registry import COMPOUND, MESH, TRIANGLE, ShapeData, ShapeRegistry
from ..utils.packing import compact_true, select_cols
from ..utils.vec import Quat, Vec3, integrate_orientation

_BIG_F = 3.0e38


class ChildPairs(NamedTuple):
    """Expanded child-pair records (capacity MPC × E, flattened)."""

    body_a: torch.Tensor  # (M,) scene body owning side A of the record
    body_b: torch.Tensor
    slot: torch.Tensor  # (M,) int32 expansion slot (for cache keying)
    valid: torch.Tensor
    # Resolved convex child data (canonical: type_i <= type_j):
    type_i: torch.Tensor
    type_j: torch.Tensor
    params_i: torch.Tensor  # (M, 12)
    params_j: torch.Tensor
    pos_i: Vec3  # world child poses
    pos_j: Vec3
    orn_i: Quat
    orn_j: Quat
    shape_i: torch.Tensor  # shape rows; -1 for triangles
    shape_j: torch.Tensor
    swapped: torch.Tensor  # (M,) bool: the i side is not scene body_a
    conv_is_a: torch.Tensor  # (M,) bool: the convex (non-compound) body is scene body_a
    overflow: torch.Tensor  # () bool
    t: torch.Tensor  # (M,) CCD evaluation time of the record's poses (0: no CCD)


def _sphere_vs_aabb(mn, mx, cx, cy, cz, radius):
    """Squared clamp-distance from a sphere center to an AABB, and the overlap mask.
    mn/mx: (..., 3); cx/cy/cz, radius broadcastable to the leading dims."""
    clip = lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)
    qx = clip(cx, mn[..., 0], mx[..., 0]) - cx
    qy = clip(cy, mn[..., 1], mx[..., 1]) - cy
    qz = clip(cz, mn[..., 2], mx[..., 2]) - cz
    d2 = qx * qx + qy * qy + qz * qz
    return d2 <= radius * radius, d2


def _child_aabb_overlap(shapes: ShapeData, child_rows, other_center_local: Vec3, other_radius):
    """The other body's bounding sphere vs each child's local AABB. child_rows: (MPC, W)."""
    rows = child_rows.long()
    return _sphere_vs_aabb(
        shapes.child_aabb_min[rows], shapes.child_aabb_max[rows],
        other_center_local.x[:, None], other_center_local.y[:, None],
        other_center_local.z[:, None], other_radius[:, None],
    )


def _argsort(key):
    return torch.sort(key, dim=-1, stable=True).indices


def _select_children_clustered(shapes: ShapeData, c_shape, other_local: Vec3, other_radius,
                               n_pick: int):
    """Two-level child candidate selection: the other body's bounding sphere against the
    shape's cluster AABBs, the ``n_pick`` nearest overlapping clusters, each expanded to
    CLUSTER_SIZE child rows. Returns (rows (MPC, n_pick·CS), candidate_ok, overflow);
    overflow fires when more clusters overlap than are examined."""
    CS = ShapeRegistry.CLUSTER_SIZE
    crow = shapes.shape_cluster_row[c_shape.long()]
    crow_c = crow.clamp_min(0).long()
    counts = shapes.cl_count[crow_c]
    ovb, d2 = _sphere_vs_aabb(
        shapes.cl_min[crow_c], shapes.cl_max[crow_c],
        other_local.x[:, None], other_local.y[:, None], other_local.z[:, None],
        other_radius[:, None],
    )
    ov = ovb & (counts > 0) & (crow >= 0)[:, None]
    n_pick = min(n_pick, ov.shape[1])
    overflow = (ov.sum(-1) > n_pick).any()
    order = _argsort(torch.where(ov, d2, _BIG_F))[:, :n_pick]
    pick_first = select_cols(shapes.cl_first[crow_c], order)
    pick_cnt = select_cols(counts, order)
    pick_ok = select_cols(ov, order)
    sub = torch.arange(CS, dtype=torch.int32, device=order.device)
    rows = pick_first[:, :, None] + sub[None, None, :]
    ok = pick_ok[:, :, None] & (sub[None, None, :] < pick_cnt[:, :, None])
    rows = rows.clamp_max(shapes.child_shape.shape[0] - 1)
    m = rows.shape[0]
    return rows.reshape(m, -1), ok.reshape(m, -1), overflow


def _pick_nearest(rows, ov, d2, n_keep: int):
    """Keep the ``n_keep`` nearest overlapping children, then re-sort the kept set by
    child row so slots stay stable while the same children remain in contact."""
    key = torch.where(ov, d2, _BIG_F)
    order = _argsort(key)[:, :n_keep]
    picked_rows = select_cols(rows, order)
    picked_ok = select_cols(ov, order)
    rkey = torch.where(picked_ok, picked_rows, 2**31 - 1)
    stable = _argsort(rkey)
    return select_cols(picked_rows, stable), select_cols(picked_ok, stable)


def expand_compound_pairs(
    state: BodyState,
    shapes: ShapeData,
    pair_a: torch.Tensor,
    pair_b: torch.Tensor,
    pair_valid: torch.Tensor,
    max_compound_pairs: int,
    children_per_pair: int,
    child_window: int,
    flag_both_comp: bool = True,
    pair_t=None,
    dt=0.0,
) -> ChildPairs:
    """Compact compound-involved pairs and expand them into child convex records.
    ``flag_both_comp``: raise overflow on compound-vs-compound pairs. ``pair_t``: per-pair
    evaluation time (CCD; None = 0)."""
    dev = pair_a.device
    pa, pb = pair_a.long(), pair_b.long()
    sa = state.shape[pa].clamp_min(0).long()
    sb = state.shape[pb].clamp_min(0).long()
    ta = torch.where(state.shape[pa] >= 0, shapes.type[sa], -1)
    tb = torch.where(state.shape[pb] >= 0, shapes.type[sb], -1)
    comp_a = (ta == COMPOUND) | (ta == MESH)
    comp_b = (tb == COMPOUND) | (tb == MESH)
    is_comp = pair_valid & (comp_a | comp_b)
    both_comp = pair_valid & comp_a & comp_b

    count = (is_comp & ~both_comp).sum()
    sel, _ = compact_true(is_comp & ~both_comp, max_compound_pairs)
    sel = sel.long()
    live_pair = torch.arange(max_compound_pairs, device=dev) < count
    overflow = count > max_compound_pairs
    if flag_both_comp:
        overflow = overflow | both_comp.any()

    # Orient so C = the compound side, V = the convex side.
    a_sel = pair_a[sel]
    b_sel = pair_b[sel]
    a_is_comp = comp_a[sel]
    c_body = torch.where(a_is_comp, a_sel, b_sel).long()
    v_body = torch.where(a_is_comp, b_sel, a_sel).long()
    c_shape = state.shape[c_body].clamp_min(0)
    v_shape = state.shape[v_body].clamp_min(0).long()

    t_sel = pair_t[sel] if pair_t is not None else torch.zeros(a_sel.shape, device=dev)

    c_pos = state.pos[c_body] + state.vel[c_body] * t_sel
    c_orn = integrate_orientation(state.orn[c_body], state.omega[c_body], t_sel)
    v_pos = state.pos[v_body] + state.vel[v_body] * t_sel
    other_local = c_orn.rotate_inverse(v_pos - c_pos)
    # Selection radius: the other body's bounding sphere plus the remaining in-step motion
    # and the resting margin.
    rel_speed = (state.vel[c_body] - state.vel[v_body]).length()
    slack = (
        rel_speed * torch.clamp_min(float(dt) - t_sel, 0.0)
        + 0.5 * (state.spec_margin_min[c_body] + state.spec_margin_min[v_body])
        + 1e-3
    )
    v_radius = shapes.max_radius[v_shape] + slack

    n_pick = max(1, child_window // ShapeRegistry.CLUSTER_SIZE)
    rows, cand_ok, cl_ovf = _select_children_clustered(shapes, c_shape, other_local, v_radius,
                                                       n_pick)
    ov, d2 = _child_aabb_overlap(shapes, rows, other_local, v_radius)
    ov = ov & cand_ok
    child_overflow = (ov.sum(-1) > children_per_pair).any()
    overflow = overflow | child_overflow | cl_ovf
    picked_rows, picked_ok = _pick_nearest(rows, ov, d2, children_per_pair)

    E = children_per_pair
    MPC = max_compound_pairs
    M = MPC * E
    rec_pair = torch.arange(MPC, device=dev).repeat_interleave(E)
    rec_slot = torch.arange(E, dtype=torch.int32, device=dev).repeat(MPC)
    child_row = picked_rows.reshape(M).long()
    rec_valid = picked_ok.reshape(M) & live_pair[rec_pair]

    cb = c_body[rec_pair]
    vb = v_body[rec_pair]
    body_a = torch.minimum(cb, vb).to(torch.int32)
    body_b = torch.maximum(cb, vb).to(torch.int32)

    # Resolve the child's convex shape and world pose.
    cs = shapes.child_shape[child_row]
    is_tri = cs < 0
    cs_c = cs.clamp_min(0).long()
    child_type = torch.where(is_tri, TRIANGLE, shapes.type[cs_c])
    tri12 = torch.nn.functional.pad(shapes.child_tri[child_row], (0, 3))
    child_params = torch.where(is_tri[:, None], tri12, shapes.params[cs_c])
    cp = shapes.child_pos[child_row]
    co = shapes.child_orn[child_row]
    local_p = Vec3(cp[:, 0], cp[:, 1], cp[:, 2])
    local_q = Quat(co[:, 0], co[:, 1], co[:, 2], co[:, 3])
    t_rec = t_sel[rec_pair]
    cpos_r = state.pos[cb] + state.vel[cb] * t_rec
    corn_r = integrate_orientation(state.orn[cb], state.omega[cb], t_rec)
    child_pos = cpos_r + corn_r.rotate(local_p)
    child_orn = corn_r.mul(local_q)

    v_type = shapes.type[v_shape][rec_pair]
    v_params = shapes.params[v_shape][rec_pair]
    v_pos_r = state.pos[vb] + state.vel[vb] * t_rec
    v_orn_r = integrate_orientation(state.orn[vb], state.omega[vb], t_rec)
    v_shape_r = v_shape[rec_pair].to(torch.int32)

    # Canonical order: lower type id = i.
    swap = child_type > v_type
    child_row_shape = torch.where(is_tri, -1, cs_c.to(torch.int32))
    i_owner = torch.where(swap, vb, cb)
    return ChildPairs(
        body_a=body_a,
        body_b=body_b,
        slot=(rec_pair * E + rec_slot).to(torch.int32),
        valid=rec_valid,
        type_i=torch.where(swap, v_type, child_type),
        type_j=torch.where(swap, child_type, v_type),
        params_i=torch.where(swap[:, None], v_params, child_params),
        params_j=torch.where(swap[:, None], child_params, v_params),
        pos_i=v_pos_r.where(swap, child_pos),
        pos_j=child_pos.where(swap, v_pos_r),
        orn_i=v_orn_r.where(swap, child_orn),
        orn_j=child_orn.where(swap, v_orn_r),
        shape_i=torch.where(swap, v_shape_r, child_row_shape),
        shape_j=torch.where(swap, child_row_shape, v_shape_r),
        swapped=i_owner != body_a.long(),
        conv_is_a=vb == body_a.long(),
        overflow=overflow,
        t=t_rec,
    )


def _resolve_child(state: BodyState, shapes: ShapeData, child_row, owner):
    """A child's convex type, packed params, world pose and shape row (-1: triangle)."""
    cs = shapes.child_shape[child_row]
    is_tri = cs < 0
    cs_c = cs.clamp_min(0).long()
    ctype = torch.where(is_tri, TRIANGLE, shapes.type[cs_c])
    tri12 = torch.nn.functional.pad(shapes.child_tri[child_row], (0, 3))
    cparams = torch.where(is_tri[:, None], tri12, shapes.params[cs_c])
    cp = shapes.child_pos[child_row]
    co = shapes.child_orn[child_row]
    lp = Vec3(cp[:, 0], cp[:, 1], cp[:, 2])
    lq = Quat(co[:, 0], co[:, 1], co[:, 2], co[:, 3])
    wpos = state.pos[owner] + state.orn[owner].rotate(lp)
    worn = state.orn[owner].mul(lq)
    return ctype, cparams, wpos, worn, torch.where(is_tri, -1, cs_c.to(torch.int32))


def expand_compound_compound(
    state: BodyState,
    shapes: ShapeData,
    pair_a: torch.Tensor,
    pair_b: torch.Tensor,
    pair_valid: torch.Tensor,
    max_cc_pairs: int,
    children_per_side: int,
    child_window: int,
) -> ChildPairs:
    """Compound/mesh vs compound/mesh pairs: per pair, the ``children_per_side`` children
    of each side nearest to overlapping the other (the bounding prefilter in each side's
    local frame) combine into children_per_side² convex child-pair records. Slots key
    the warm-start cache."""
    dev = pair_a.device
    pa, pb = pair_a.long(), pair_b.long()
    sa = state.shape[pa].clamp_min(0).long()
    sb = state.shape[pb].clamp_min(0).long()
    ta = torch.where(state.shape[pa] >= 0, shapes.type[sa], -1)
    tb = torch.where(state.shape[pb] >= 0, shapes.type[sb], -1)
    comp_a = (ta == COMPOUND) | (ta == MESH)
    comp_b = (tb == COMPOUND) | (tb == MESH)
    both = pair_valid & comp_a & comp_b

    count = both.sum()
    sel, _ = compact_true(both, max_cc_pairs)
    sel = sel.long()
    live_pair = torch.arange(max_cc_pairs, device=dev) < count
    overflow = count > max_cc_pairs

    a_sel = pair_a[sel].long()
    b_sel = pair_b[sel].long()
    shape_a = state.shape[a_sel].clamp_min(0).long()
    shape_b = state.shape[b_sel].clamp_min(0).long()
    n_pick = max(1, child_window // ShapeRegistry.CLUSTER_SIZE)

    def pick_children(c_shape, c_body, o_body, o_shape):
        other_local = state.orn[c_body].rotate_inverse(state.pos[o_body] - state.pos[c_body])
        radius = shapes.max_radius[o_shape]
        rows, cand_ok, cl_ovf = _select_children_clustered(shapes, c_shape, other_local,
                                                           radius, n_pick)
        ov, d2 = _child_aabb_overlap(shapes, rows, other_local, radius)
        ov = ov & cand_ok
        pr, po = _pick_nearest(rows, ov, d2, children_per_side)
        return pr, po, (ov.sum(-1) > children_per_side).any() | cl_ovf

    rows_a, ok_a, ovf_a = pick_children(shape_a, a_sel, b_sel, shape_b)
    rows_b, ok_b, ovf_b = pick_children(shape_b, b_sel, a_sel, shape_a)
    overflow = overflow | ovf_a | ovf_b

    E = children_per_side
    MPC = max_cc_pairs
    rec_pair = torch.arange(MPC, device=dev).repeat_interleave(E * E)
    rec_ka = torch.arange(E, device=dev).repeat_interleave(E).repeat(MPC)
    rec_kb = torch.arange(E, device=dev).repeat(MPC * E)
    row_a = rows_a[rec_pair, rec_ka].long()
    row_b = rows_b[rec_pair, rec_kb].long()
    rec_valid = ok_a[rec_pair, rec_ka] & ok_b[rec_pair, rec_kb] & live_pair[rec_pair]

    oa = a_sel[rec_pair]
    ob = b_sel[rec_pair]
    type_ca, params_ca, pos_ca, orn_ca, srow_ca = _resolve_child(state, shapes, row_a, oa)
    type_cb, params_cb, pos_cb, orn_cb, srow_cb = _resolve_child(state, shapes, row_b, ob)
    body_a = torch.minimum(oa, ob)

    swap = type_ca > type_cb
    i_owner = torch.where(swap, ob, oa)
    return ChildPairs(
        body_a=body_a.to(torch.int32),
        body_b=torch.maximum(oa, ob).to(torch.int32),
        slot=(rec_pair * E * E + rec_ka * E + rec_kb).to(torch.int32),
        valid=rec_valid,
        type_i=torch.where(swap, type_cb, type_ca),
        type_j=torch.where(swap, type_ca, type_cb),
        params_i=torch.where(swap[:, None], params_cb, params_ca),
        params_j=torch.where(swap[:, None], params_ca, params_cb),
        pos_i=pos_cb.where(swap, pos_ca),
        pos_j=pos_ca.where(swap, pos_cb),
        orn_i=orn_cb.where(swap, orn_ca),
        orn_j=orn_ca.where(swap, orn_cb),
        shape_i=torch.where(swap, srow_cb, srow_ca),
        shape_j=torch.where(swap, srow_ca, srow_cb),
        swapped=i_owner != body_a,
        # The convex side of a record with a mesh triangle is the owner of the other
        # child. The JAX package takes the owner of the j side (compound.py:446), which is
        # the mesh itself where the other child's type id is below the triangle's (a
        # sphere, capsule or box): its one-sided test then culls every such record, and
        # such compounds fall through meshes. The port repairs it (ROADMAP queue 3).
        conv_is_a=torch.where(srow_cb == -1, oa, torch.where(srow_ca == -1, ob, torch.where(
            swap, oa, ob))) == body_a,
        overflow=overflow,
        t=torch.zeros(body_a.shape, device=dev),
    )
