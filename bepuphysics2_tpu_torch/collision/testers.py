"""Vectorized convex pair testers — speculative contact manifold generation.

Counterpart of ``sphere_sphere``, ``sphere_box`` and ``box_box`` in
``bepuphysics2_tpu/collision/testers.py`` (reference CollisionTasks/SpherePairTester.cs,
SphereBoxTester.cs, BoxPairTester.cs). Each tester processes every pair record at once and
always produces a manifold (negative depth when separated); the caller masks records.

Conventions: the normal points from B to A; contact offsets are world-space relative to
A's center; A is the first shape of the canonical type pair.
"""
from __future__ import annotations

import torch

from ..utils.vec import Quat, Vec3
from .manifold import Manifold

_EPS = 1e-10


def _col0(n, col, fill, dtype, device):
    """(n, 4) tensor of ``fill`` with column 0 set to ``col``."""
    out = torch.full((n, 4), fill, dtype=dtype, device=device)
    out[:, 0] = col
    return out


def _single_contact(offset: Vec3, depth, normal: Vec3, feature=0) -> Manifold:
    n = offset.x.shape[0]
    dev = offset.x.device
    f32 = torch.float32
    return Manifold(
        normal=normal,
        offset_a=Vec3(_col0(n, offset.x, 0.0, f32, dev), _col0(n, offset.y, 0.0, f32, dev),
                      _col0(n, offset.z, 0.0, f32, dev)),
        depth=_col0(n, depth, 0.0, f32, dev),
        feature=torch.full((n, 4), feature, dtype=torch.int32, device=dev),
        contact_mask=_col0(n, True, False, torch.bool, dev),
    )


def _take(arr, idx):
    """``arr[i, idx[i]]`` per row (the JAX package's select_col)."""
    return torch.gather(arr, -1, idx.long()[..., None])[..., 0]


def sphere_sphere(pos_ab: Vec3, params_a, params_b) -> Manifold:
    """reference: CollisionTasks/SpherePairTester.cs:25."""
    ra = params_a[:, 0]
    rb = params_b[:, 0]
    d2 = pos_ab.length_squared()
    d = torch.sqrt(d2)
    inv_d = torch.where(d > _EPS, 1.0 / d.clamp_min(_EPS), 0.0)
    dir_ab = pos_ab * inv_d
    dir_ab = dir_ab.where(d > _EPS, Vec3.full(d.shape, 0.0, 1.0, 0.0, device=d.device))
    depth = ra + rb - d
    normal = -dir_ab
    contact = dir_ab * (ra - 0.5 * depth)
    return _single_contact(contact, depth, normal)


def sphere_box(pos_ab: Vec3, orn_b: Quat, params_a, params_b) -> Manifold:
    """Sphere A vs box B: clamp the sphere center (in B's frame) to the box, interior
    fallback through the nearest face (reference: CollisionTasks/SphereBoxTester.cs)."""
    r = params_a[:, 0]
    h = Vec3(params_b[:, 0], params_b[:, 1], params_b[:, 2])
    local_center = orn_b.rotate_inverse(-pos_ab)
    clamped = local_center.max(-1.0 * h).min(h)
    offset = local_center - clamped
    dist2 = offset.length_squared()
    outside = dist2 > _EPS
    dist = torch.sqrt(dist2.clamp_min(_EPS))

    face_dist = Vec3(h.x - local_center.x.abs(), h.y - local_center.y.abs(),
                     h.z - local_center.z.abs())
    min_fd = torch.minimum(face_dist.x, torch.minimum(face_dist.y, face_dist.z))
    sel_x = face_dist.x == min_fd
    sel_y = (~sel_x) & (face_dist.y == min_fd)
    sel_z = ~(sel_x | sel_y)
    sgn = lambda c: torch.where(c >= 0, 1.0, -1.0)
    interior_normal = Vec3(
        torch.where(sel_x, sgn(local_center.x), 0.0),
        torch.where(sel_y, sgn(local_center.y), 0.0),
        torch.where(sel_z, sgn(local_center.z), 0.0),
    )
    local_normal = (offset * (1.0 / dist)).where(outside, interior_normal)
    depth = torch.where(outside, r - dist, r + min_fd)

    surface_local = clamped.where(
        outside,
        Vec3(
            torch.where(sel_x, sgn(local_center.x) * h.x, local_center.x),
            torch.where(sel_y, sgn(local_center.y) * h.y, local_center.y),
            torch.where(sel_z, sgn(local_center.z) * h.z, local_center.z),
        ),
    )
    normal = orn_b.rotate(local_normal)
    contact_world_rel_a = orn_b.rotate(surface_local) + pos_ab
    contact = normal * -(r - 0.5 * depth.clamp_min(0.0))
    contact = contact.where(depth < r, contact_world_rel_a)
    return _single_contact(contact, depth, normal)


def _pick(vecs, k):
    return Vec3(
        torch.where(k == 0, vecs[0].x, torch.where(k == 1, vecs[1].x, vecs[2].x)),
        torch.where(k == 0, vecs[0].y, torch.where(k == 1, vecs[1].y, vecs[2].y)),
        torch.where(k == 0, vecs[0].z, torch.where(k == 1, vecs[1].z, vecs[2].z)),
    )


def _pick_h(h3, k):
    return torch.where(k == 0, h3.x, torch.where(k == 1, h3.y, h3.z))


def _quad_winding(vu, vv):
    """Sign of the incident quad's signed area in (u, v)."""
    area = torch.zeros_like(vu[0])
    for m in range(4):
        area = area + vu[m] * vv[(m + 1) % 4] - vu[(m + 1) % 4] * vv[m]
    return torch.sign(torch.where(area == 0, 1.0, area))


def _face_candidates(N, n_ref_out: Vec3, h_ref: Vec3, ref_axes, inc_axes, h_inc,
                     t_inc: Vec3):
    """24 masked face-manifold candidates in the reference face's frame: 4 incident
    vertices, 16 incident-edge × slab intersections, 4 rectangle corners. Returns
    (points Vec3 (N, 24), mask (N, 24), feature (N, 24))."""
    dev = t_inc.x.device
    dots = torch.stack([n_ref_out.dot(ax).abs() for ax in ref_axes], -1)
    rdim = torch.argmax(dots, -1)
    u_ax = _pick(ref_axes, (rdim + 1) % 3)
    v_ax = _pick(ref_axes, (rdim + 2) % 3)
    h_u = _pick_h(h_ref, (rdim + 1) % 3)
    h_v = _pick_h(h_ref, (rdim + 2) % 3)

    inc_dots = torch.stack([n_ref_out.dot(ax) for ax in inc_axes], -1)
    k_inc = torch.argmax(inc_dots.abs(), -1)
    s_inc = -torch.sign(_take(inc_dots, k_inc))
    s_inc = torch.where(s_inc == 0, 1.0, s_inc)
    inc_n_ax = _pick(inc_axes, k_inc)
    inc_u_ax = _pick(inc_axes, (k_inc + 1) % 3)
    inc_v_ax = _pick(inc_axes, (k_inc + 2) % 3)
    inc_h_n = _pick_h(h_inc, k_inc)
    inc_h_u = _pick_h(h_inc, (k_inc + 1) % 3)
    inc_h_v = _pick_h(h_inc, (k_inc + 2) % 3)
    face_center = t_inc + inc_n_ax * (s_inc * inc_h_n)
    signs = [(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)]
    verts = [face_center + inc_u_ax * (su * inc_h_u) + inc_v_ax * (sv * inc_h_v)
             for su, sv in signs]
    vu = [u_ax.dot(p) for p in verts]
    vv = [v_ax.dot(p) for p in verts]

    cand_pts, cand_mask, cand_feat = [], [], []
    feat = lambda f: torch.full((N,), f, dtype=torch.int32, device=dev)
    eps = 1e-6
    for m in range(4):  # (a) incident verts inside the rectangle
        inside = (vu[m].abs() <= h_u + eps) & (vv[m].abs() <= h_v + eps)
        cand_pts.append(verts[m])
        cand_mask.append(inside)
        cand_feat.append(feat(m))
    for m in range(4):  # (b) incident edge × slab-plane intersections
        p0 = verts[m]
        p1 = verts[(m + 1) % 4]
        u0, u1 = vu[m], vu[(m + 1) % 4]
        v0, v1 = vv[m], vv[(m + 1) % 4]
        for p_idx, (c0, c1, lim, other0, other1, other_lim) in enumerate(
            [
                (u0, u1, h_u, v0, v1, h_v),
                (u0, u1, -h_u, v0, v1, h_v),
                (v0, v1, h_v, u0, u1, h_u),
                (v0, v1, -h_v, u0, u1, h_u),
            ]
        ):
            denom = c1 - c0
            frac = (lim - c0) / torch.where(denom.abs() > 1e-9, denom, 1e-9)
            valid = (denom.abs() > 1e-9) & (frac >= 0.0) & (frac <= 1.0)
            other = other0 + (other1 - other0) * frac
            valid = valid & (other.abs() <= other_lim + eps)
            cand_pts.append(p0 + (p1 - p0) * frac)
            cand_mask.append(valid)
            cand_feat.append(feat(16 + m * 4 + p_idx))
    # (c) rectangle corners inside the incident quad, lifted onto the incident plane.
    inc_n = inc_n_ax * s_inc
    n_dim = _pick(ref_axes, rdim)
    plane_d = inc_n.dot(verts[0])
    denom_w = inc_n.dot(n_dim)
    winding = _quad_winding(vu, vv)
    for ci, (su, sv) in enumerate(signs):
        cu = su * h_u
        cv = sv * h_v
        inside = torch.ones((N,), dtype=torch.bool, device=dev)
        for m in range(4):
            eu = vu[(m + 1) % 4] - vu[m]
            ev = vv[(m + 1) % 4] - vv[m]
            cross = eu * (cv - vv[m]) - ev * (cu - vu[m])
            inside = inside & (cross * winding >= -eps)
        base = u_ax * cu + v_ax * cv
        w = (plane_d - inc_n.dot(base)) / torch.where(denom_w.abs() > 1e-9, denom_w, 1e-9)
        cand_pts.append(base + n_dim * w)
        cand_mask.append(inside & (denom_w.abs() > 1e-9))
        cand_feat.append(feat(64 + ci))

    pts = Vec3(
        torch.stack([p.x for p in cand_pts], -1),
        torch.stack([p.y for p in cand_pts], -1),
        torch.stack([p.z for p in cand_pts], -1),
    )
    return pts, torch.stack(cand_mask, -1), torch.stack(cand_feat, -1)


def box_box(pos_ab: Vec3, orn_a: Quat, orn_b: Quat, params_a, params_b) -> Manifold:
    """Box-box: SAT over 15 axes, then a fixed-candidate face manifold reduced to ≤4
    contacts, or one closest-point contact for an edge-edge axis (reference:
    CollisionTasks/BoxPairTester.cs; same formulation as the JAX tester)."""
    N = params_a.shape[0]
    dev = params_a.device
    ha = Vec3(params_a[:, 0], params_a[:, 1], params_a[:, 2])
    hb = Vec3(params_b[:, 0], params_b[:, 1], params_b[:, 2])

    q_ab = orn_a.conjugate().mul(orn_b)
    rb = q_ab.to_matrix()
    t = orn_a.rotate_inverse(pos_ab)

    b_axes = [rb.rx, rb.ry, rb.rz]
    ha_arr = [ha.x, ha.y, ha.z]
    hb_arr = [hb.x, hb.y, hb.z]
    ones = torch.ones((N,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((N,), dtype=torch.float32, device=dev)
    a_axes = [Vec3(ones, zeros, zeros), Vec3(zeros, ones, zeros), Vec3(zeros, zeros, ones)]

    def project_b(axis: Vec3):
        return (
            axis.dot(b_axes[0]).abs() * hb_arr[0]
            + axis.dot(b_axes[1]).abs() * hb_arr[1]
            + axis.dot(b_axes[2]).abs() * hb_arr[2]
        )

    def project_a(axis: Vec3):
        return axis.x.abs() * ha_arr[0] + axis.y.abs() * ha_arr[1] + axis.z.abs() * ha_arr[2]

    big = torch.full((N,), 3.0e38, dtype=torch.float32, device=dev)
    best_depth = big
    best_axis = Vec3.full((N,), 0.0, 1.0, 0.0, device=dev)
    best_id = torch.zeros((N,), dtype=torch.int32, device=dev)
    min_ext = torch.minimum(
        torch.minimum(torch.minimum(ha.x, ha.y), ha.z),
        torch.minimum(torch.minimum(hb.x, hb.y), hb.z),
    )

    def consider(depth, axis, axis_id, best_depth, best_axis, best_id, bias=1.0):
        flip = axis.dot(t) > 0.0
        axis = axis.where(~flip, -1.0 * axis)
        penalty = (bias - 1.0) * (0.05 * min_ext + depth.abs())
        better = depth + penalty < best_depth
        return (
            torch.where(better, depth, best_depth),
            axis.where(better, best_axis),
            torch.where(better, axis_id, best_id),
        )

    # Deterministic tie-break biases: B faces must be clearly shallower than A faces,
    # edge axes clearly shallower than any face.
    FACE_B_BIAS = 1.0 + 1e-3
    EDGE_BIAS = 1.05
    for i in range(3):
        axis = a_axes[i]
        depth = ha_arr[i] + project_b(axis) - axis.dot(t).abs()
        best_depth, best_axis, best_id = consider(depth, axis, i, best_depth, best_axis, best_id)
    for j in range(3):
        axis = b_axes[j]
        depth = project_a(axis) + hb_arr[j] - axis.dot(t).abs()
        best_depth, best_axis, best_id = consider(
            depth, axis, 3 + j, best_depth, best_axis, best_id, bias=FACE_B_BIAS
        )
    for i in range(3):
        for j in range(3):
            raw = a_axes[i].cross(b_axes[j])
            ln = raw.length()
            ok = ln > 1e-6
            axis = raw * torch.where(ok, 1.0 / ln.clamp_min(1e-6), 0.0)
            depth = torch.where(ok, project_a(axis) + project_b(axis) - axis.dot(t).abs(), big)
            best_depth, best_axis, best_id = consider(
                depth, axis, 6 + i * 3 + j, best_depth, best_axis, best_id, bias=EDGE_BIAS
            )

    face_contact = best_id < 6
    a_is_ref = best_id < 3
    n_local = best_axis  # B→A in A frame

    # A as reference (A frame); B as reference (B frame), mapped back into A's frame.
    pts_a, mask_a, feat_a = _face_candidates(N, -1.0 * n_local, ha, a_axes, b_axes, hb, t)
    to_b_frame = lambda v: Vec3(rb.rx.dot(v), rb.ry.dot(v), rb.rz.dot(v))
    n_local_b = to_b_frame(n_local)
    t_b = to_b_frame(-1.0 * t)
    b_frame_axes = [Vec3(ones, zeros, zeros), Vec3(zeros, ones, zeros), Vec3(zeros, zeros, ones)]
    a_axes_in_b = [
        Vec3(rb.rx.x, rb.ry.x, rb.rz.x),
        Vec3(rb.rx.y, rb.ry.y, rb.rz.y),
        Vec3(rb.rx.z, rb.ry.z, rb.rz.z),
    ]
    pts_b, mask_b, feat_b = _face_candidates(
        N, 1.0 * n_local_b, hb, b_frame_axes, a_axes_in_b, ha, t_b
    )
    c = lambda v: v[:, None]
    pts_b_in_a = Vec3(
        c(t.x) + c(rb.rx.x) * pts_b.x + c(rb.ry.x) * pts_b.y + c(rb.rz.x) * pts_b.z,
        c(t.y) + c(rb.rx.y) * pts_b.x + c(rb.ry.y) * pts_b.y + c(rb.rz.y) * pts_b.z,
        c(t.z) + c(rb.rx.z) * pts_b.x + c(rb.ry.z) * pts_b.y + c(rb.rz.z) * pts_b.z,
    )

    am = a_is_ref[:, None]
    pts = Vec3(
        torch.where(am, pts_a.x, pts_b_in_a.x),
        torch.where(am, pts_a.y, pts_b_in_a.y),
        torch.where(am, pts_a.z, pts_b_in_a.z),
    )
    cmask = torch.where(am, mask_a, mask_b)
    cfeat = torch.where(am, feat_a, feat_b + 4096)

    # Per-candidate depth along n (B→A).
    s_a = project_a(n_local)
    s_b = project_b(n_local)
    np_dot = c(n_local.x) * pts.x + c(n_local.y) * pts.y + c(n_local.z) * pts.z
    depth_a_ref = s_a[:, None] + np_dot
    depth_b_ref = (s_b + n_local.dot(t))[:, None] - np_dot
    depth_pts = torch.where(am, depth_a_ref, depth_b_ref)
    neg_big = -3.0e38
    depth_masked = torch.where(cmask, depth_pts, neg_big)

    # ---- Reduce ≤24 candidates to ≤4: deepest, farthest, then two extremal sides.
    K = depth_masked.shape[1]
    kk = torch.arange(K, device=dev)[None, :]
    pick_max = lambda scores, taken: torch.argmax(torch.where(taken, neg_big, scores), -1)
    g = _take
    taken = ~cmask
    i0 = pick_max(depth_masked, taken)
    p0 = Vec3(g(pts.x, i0), g(pts.y, i0), g(pts.z, i0))
    taken = taken | (kk == i0[:, None])
    d0 = Vec3(pts.x - c(p0.x), pts.y - c(p0.y), pts.z - c(p0.z))
    i1 = pick_max(d0.length_squared(), taken)
    p1 = Vec3(g(pts.x, i1), g(pts.y, i1), g(pts.z, i1))
    taken = taken | (kk == i1[:, None])
    edge = p1 - p0
    cr = Vec3(
        c(edge.y) * d0.z - c(edge.z) * d0.y,
        c(edge.z) * d0.x - c(edge.x) * d0.z,
        c(edge.x) * d0.y - c(edge.y) * d0.x,
    )
    side = cr.x * c(n_local.x) + cr.y * c(n_local.y) + cr.z * c(n_local.z)
    i2 = pick_max(side, taken)
    taken = taken | (kk == i2[:, None])
    i3 = pick_max(-side, taken)

    sel = torch.stack([i0, i1, i2, i3], -1)
    valid_sel = torch.gather(cmask, 1, sel)
    for a_i in range(1, 4):
        dup = torch.zeros(N, dtype=torch.bool, device=dev)
        for b_i in range(a_i):
            dup = dup | (sel[:, a_i] == sel[:, b_i])
        valid_sel[:, a_i] = valid_sel[:, a_i] & ~dup

    c_pts = Vec3(torch.gather(pts.x, 1, sel), torch.gather(pts.y, 1, sel),
                 torch.gather(pts.z, 1, sel))
    c_depth = torch.gather(torch.where(cmask, depth_pts, 0.0), 1, sel)
    c_feat = torch.gather(cfeat, 1, sel)

    # ---- Edge-edge: single contact at the closest point between the support edges.
    ei = torch.div(best_id - 6, 3, rounding_mode="floor")
    ej = torch.remainder(best_id - 6, 3)
    a_dir = _pick(a_axes, ei)
    b_dir = _pick(b_axes, ej)
    to_b = -1.0 * n_local
    corner_a = Vec3(
        torch.where(ei == 0, 0.0, torch.sign(to_b.x) * ha.x),
        torch.where(ei == 1, 0.0, torch.sign(to_b.y) * ha.y),
        torch.where(ei == 2, 0.0, torch.sign(to_b.z) * ha.z),
    )
    to_a_b = Vec3(b_axes[0].dot(n_local), b_axes[1].dot(n_local), b_axes[2].dot(n_local))
    corner_b_local = Vec3(
        torch.where(ej == 0, 0.0, torch.sign(to_a_b.x) * hb.x),
        torch.where(ej == 1, 0.0, torch.sign(to_a_b.y) * hb.y),
        torch.where(ej == 2, 0.0, torch.sign(to_a_b.z) * hb.z),
    )
    corner_b = t + Vec3(
        rb.rx.x * corner_b_local.x + rb.ry.x * corner_b_local.y + rb.rz.x * corner_b_local.z,
        rb.rx.y * corner_b_local.x + rb.ry.y * corner_b_local.y + rb.rz.y * corner_b_local.z,
        rb.rx.z * corner_b_local.x + rb.ry.z * corner_b_local.y + rb.rz.z * corner_b_local.z,
    )
    w0 = corner_a - corner_b
    b_ = a_dir.dot(b_dir)
    d_ = a_dir.dot(w0)
    e_ = b_dir.dot(w0)
    den = 1.0 - b_ * b_
    den_ok = den.abs() > 1e-9
    s_par = torch.where(den_ok, (b_ * e_ - d_) / torch.where(den_ok, den, 1.0), 0.0)
    edge_pt = corner_a + a_dir * s_par

    fm = face_contact[:, None]
    f32 = torch.float32
    out_pts = Vec3(
        torch.where(fm, c_pts.x, _col0(N, edge_pt.x, 0.0, f32, dev)),
        torch.where(fm, c_pts.y, _col0(N, edge_pt.y, 0.0, f32, dev)),
        torch.where(fm, c_pts.z, _col0(N, edge_pt.z, 0.0, f32, dev)),
    )
    out_depth = torch.where(fm, c_depth, _col0(N, best_depth, 0.0, f32, dev))
    out_feat = torch.where(fm, c_feat, 8192 + best_id[:, None].expand(N, 4))
    out_mask = torch.where(fm, valid_sel, _col0(N, True, False, torch.bool, dev))

    ma = orn_a.to_matrix()
    world_pts = Vec3(
        c(ma.rx.x) * out_pts.x + c(ma.ry.x) * out_pts.y + c(ma.rz.x) * out_pts.z,
        c(ma.rx.y) * out_pts.x + c(ma.ry.y) * out_pts.y + c(ma.rz.y) * out_pts.z,
        c(ma.rx.z) * out_pts.x + c(ma.ry.z) * out_pts.y + c(ma.rz.z) * out_pts.z,
    )
    return Manifold(
        normal=orn_a.rotate(n_local),
        offset_a=world_pts,
        depth=out_depth,
        feature=out_feat.to(torch.int32),
        contact_mask=out_mask,
    )
