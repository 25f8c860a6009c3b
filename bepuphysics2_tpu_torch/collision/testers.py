"""Vectorized convex pair testers — speculative contact manifold generation.

Counterpart of ``sphere_sphere``, ``sphere_capsule``, ``sphere_box``, ``capsule_capsule``,
``capsule_box``, ``box_box``, ``sphere_triangle``, ``capsule_triangle`` and
``box_triangle`` in ``bepuphysics2_tpu/collision/testers.py`` (reference
CollisionTasks/SpherePairTester.cs, SphereCapsuleTester.cs, SphereBoxTester.cs,
CapsulePairTester.cs, CapsuleBoxTester.cs, BoxPairTester.cs, SphereTriangleTester.cs,
CapsuleTriangleTester.cs, BoxTriangleTester.cs). Each tester processes every pair record
at once and always produces a manifold (negative depth when separated); the caller masks
records.

Conventions: the normal points from B to A; contact offsets are world-space relative to
A's center; A is the first shape of the canonical type pair.
"""
from __future__ import annotations

import torch

from ..utils.packing import select_cols
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


def _closest_on_segment(p: Vec3, half_length, axis: Vec3):
    """t of the closest point on the segment {t·axis, |t| ≤ hl} to point p."""
    t = p.dot(axis)
    return torch.minimum(torch.maximum(t, -half_length), half_length)


def _up(n, device):
    return Vec3.full((n,), 0.0, 1.0, 0.0, device=device)


def _cols2(n, c0, c1, fill, dtype, device):
    """(n, 4) tensor of ``fill`` with columns 0 and 1 set to ``c0`` and ``c1``."""
    out = torch.full((n, 4), fill, dtype=dtype, device=device)
    out[:, 0] = c0
    out[:, 1] = c1
    return out


def _two_contacts(p0: Vec3, p1: Vec3, depth0, depth1, normal: Vec3, second) -> Manifold:
    n = depth0.shape[0]
    dev = depth0.device
    f32 = torch.float32
    return Manifold(
        normal=normal,
        offset_a=Vec3(_cols2(n, p0.x, p1.x, 0.0, f32, dev), _cols2(n, p0.y, p1.y, 0.0, f32, dev),
                      _cols2(n, p0.z, p1.z, 0.0, f32, dev)),
        depth=_cols2(n, depth0, depth1, 0.0, f32, dev),
        feature=_cols2(n, 0, 1, 0, torch.int32, dev),
        contact_mask=_cols2(n, True, second, False, torch.bool, dev),
    )


def sphere_capsule(pos_ab: Vec3, orn_b: Quat, params_a, params_b) -> Manifold:
    """Sphere A vs capsule B (reference: CollisionTasks/SphereCapsuleTester.cs)."""
    ra = params_a[:, 0]
    rb = params_b[:, 0]
    hl = params_b[:, 1]
    axis = orn_b.rotate(_up(ra.shape[0], ra.device))
    t = _closest_on_segment(-pos_ab, hl, axis)
    closest = pos_ab + axis * t  # from A's center to the closest segment point
    d = closest.length()
    inv_d = torch.where(d > _EPS, 1.0 / d.clamp_min(_EPS), 0.0)
    dir_ab = (closest * inv_d).where(d > _EPS, _up(d.shape[0], d.device))
    depth = ra + rb - d
    normal = -dir_ab
    contact = dir_ab * (ra - 0.5 * depth)
    return _single_contact(contact, depth, normal)


def capsule_capsule(pos_ab: Vec3, orn_a: Quat, orn_b: Quat, params_a, params_b) -> Manifold:
    """Capsule-capsule via segment-segment closest points; a second contact when the
    segments are near-parallel (reference: CollisionTasks/CapsulePairTester.cs:16)."""
    ra, hla = params_a[:, 0], params_a[:, 1]
    rb, hlb = params_b[:, 0], params_b[:, 1]
    n = ra.shape[0]
    dev = ra.device
    clip = lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)
    da = orn_a.rotate(_up(n, dev))
    db = orn_b.rotate(_up(n, dev))
    r = pos_ab
    a_dot_b = da.dot(db)
    da_r = da.dot(r)
    db_r = db.dot(r)
    denom = 1.0 - a_dot_b * a_dot_b
    ta = torch.where(denom > 1e-7,
                     clip((da_r - a_dot_b * db_r) / denom.clamp_min(1e-7), -hla, hla), 0.0)
    tb = clip(db.dot(da * ta - r), -hlb, hlb)
    ta = clip(da.dot(r + db * tb), -hla, hla)

    pa = da * ta
    pb = r + db * tb
    d_vec = pb - pa
    d = d_vec.length()
    inv_d = torch.where(d > _EPS, 1.0 / d.clamp_min(_EPS), 0.0)
    dir_ab = (d_vec * inv_d).where(d > _EPS, da.cross(_up(n, dev)).normalize())
    normal = -dir_ab
    depth0 = ra + rb - d
    contact0 = pa + dir_ab * (ra - 0.5 * depth0)

    # Parallel case: a second contact from the overlap of the segments' intervals.
    parallel = denom <= 1e-3
    e0 = db_r - a_dot_b * hlb
    e1 = db_r + a_dot_b * hlb
    lo = torch.maximum(-hla, torch.minimum(e0, e1))
    hi = torch.minimum(hla, torch.maximum(e0, e1))
    pa1 = da * hi
    tb1 = clip(db.dot(pa1 - r), -hlb, hlb)
    d1 = (r + db * tb1 - pa1).length()
    depth1 = ra + rb - d1
    contact1 = pa1 + dir_ab * (ra - 0.5 * depth1)
    pa0 = da * lo
    tb0 = clip(db.dot(pa0 - r), -hlb, hlb)
    d0 = (r + db * tb0 - pa0).length()
    depth0p = ra + rb - d0
    contact0p = pa0 + dir_ab * (ra - 0.5 * depth0p)

    use0 = contact0p.where(parallel, contact0)
    dep0 = torch.where(parallel, depth0p, depth0)
    return _two_contacts(use0, contact1, dep0, depth1, normal, parallel & (hi > lo))


def _capsule_box_edge(au, av, aw, du, dv, dw, hl, eu, ev, hu, hv, hw):
    """Closest-approach candidate between the capsule segment and one representative box
    edge, in a (u, v, w) permutation of the box frame where the edge runs along w through
    (eu, ev, 0). Returns (ta, depth_core, nu, nv, nw), the normal unit and pointing toward
    the capsule center (reference capability: CollisionTasks/CapsuleBoxTester.cs)."""
    clip = lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)
    ab_u = eu - au
    ab_v = ev - av
    d_dot_ab = du * ab_u + dv * ab_v - dw * aw
    denom = torch.clamp_min(1.0 - dw * dw, 1e-15)
    ta = (d_dot_ab + aw * dw) / denom
    tb = ta * dw + aw

    absdadb = dw.abs()
    b_onto_a = hw * absdadb
    a_onto_b = hl * absdadb
    ta_min = torch.maximum(-hl, torch.minimum(hl, d_dot_ab - b_onto_a))
    ta_max = torch.minimum(hl, torch.maximum(-hl, d_dot_ab + b_onto_a))
    tb_min = torch.maximum(-hw, torch.minimum(hw, aw - a_onto_b))
    tb_max = torch.minimum(hw, torch.maximum(-hw, aw + a_onto_b))
    ta = clip(ta, ta_min, ta_max)
    tb = clip(tb, tb_min, tb_max)

    cu = au + ta * du
    cv = av + ta * dv
    cw = aw + ta * dw
    nu = cu - eu
    nv = cv - ev
    nw = cw - tb
    len2 = nu * nu + nv * nv + nw * nw
    # Degenerate (segment meets the edge): cross(d, edge_w) = (dv, -du, 0); doubly
    # degenerate (parallel): (1, 0, 0).
    fb2 = du * du + dv * dv
    use_fb = len2 < 1e-10
    use_fb2 = use_fb & (fb2 < 1e-10)
    len2 = torch.where(use_fb2, 1.0, torch.where(use_fb, fb2, len2))
    nu = torch.where(use_fb2, 1.0, torch.where(use_fb, dv, nu))
    nv = torch.where(use_fb2, 0.0, torch.where(use_fb, -du, nv))
    nw = torch.where(use_fb2, 0.0, torch.where(use_fb, 0.0, nw))
    calib = nu * au + nv * av + nw * aw
    sgn = torch.where(calib < 0.0, -1.0, 1.0)
    inv_len = sgn / torch.sqrt(len2)
    nu, nv, nw = nu * inv_len, nv * inv_len, nw * inv_len
    box_extreme = nu.abs() * hu + nv.abs() * hv + nw.abs() * hw
    cap_extreme = nu * cu + nv * cv + nw * cw
    return ta, box_extreme - cap_extreme, nu, nv, nw


def capsule_box(pos_ab: Vec3, orn_a: Quat, orn_b: Quat, params_a, params_b) -> Manifold:
    """Capsule A vs box B: 3 representative-edge + 3 face candidates, then a 2-contact
    manifold by clipping the capsule axis against the representative face in its tangent
    plane; per-contact depths from the unprojection separation (reference capability:
    CollisionTasks/CapsuleBoxTester.cs)."""
    r, hl = params_a[:, 0], params_a[:, 1]
    hb = Vec3(params_b[:, 0], params_b[:, 1], params_b[:, 2])
    N = r.shape[0]
    dev = r.device
    clip = lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)

    a = orn_b.rotate_inverse(-1.0 * pos_ab)  # capsule center in the box frame
    d = orn_b.rotate_inverse(orn_a.rotate(_up(N, dev)))  # capsule axis

    t_star = clip(-a.dot(d), -hl, hl)
    p_star = a + d * t_star
    ex = torch.where(p_star.x < 0.0, -hb.x, hb.x)
    ey = torch.where(p_star.y < 0.0, -hb.y, hb.y)
    ez = torch.where(p_star.z < 0.0, -hb.z, hb.z)

    ta_z, dep_z, nzx, nzy, nzz = _capsule_box_edge(
        a.x, a.y, a.z, d.x, d.y, d.z, hl, ex, ey, hb.x, hb.y, hb.z)
    ta_x, dep_x, nxy, nxz, nxx = _capsule_box_edge(
        a.y, a.z, a.x, d.y, d.z, d.x, hl, ey, ez, hb.y, hb.z, hb.x)
    ta_y, dep_y, nyz, nyx, nyy = _capsule_box_edge(
        a.z, a.x, a.y, d.z, d.x, d.y, hl, ez, ex, hb.z, hb.x, hb.y)

    depth, ta, n = dep_x, ta_x, Vec3(nxx, nxy, nxz)

    def pick(dep_c, ta_c, n_c, depth, ta, n):
        better = dep_c < depth
        return torch.where(better, dep_c, depth), torch.where(better, ta_c, ta), n_c.where(better, n)

    depth, ta, n = pick(dep_y, ta_y, Vec3(nyx, nyy, nyz), depth, ta, n)
    depth, ta, n = pick(dep_z, ta_z, Vec3(nzx, nzy, nzz), depth, ta, n)

    fsx = torch.where(a.x > 0.0, 1.0, -1.0)
    fsy = torch.where(a.y > 0.0, 1.0, -1.0)
    fsz = torch.where(a.z > 0.0, 1.0, -1.0)
    zero = torch.zeros((N,), dtype=torch.float32, device=dev)
    fdx = hb.x + d.x.abs() * hl - fsx * a.x
    fdy = hb.y + d.y.abs() * hl - fsy * a.y
    fdz = hb.z + d.z.abs() * hl - fsz * a.z
    depth, ta, n = pick(fdx, ta, Vec3(fsx, zero, zero), depth, ta, n)
    depth, ta, n = pick(fdy, ta, Vec3(zero, fsy, zero), depth, ta, n)
    depth, ta, n = pick(fdz, ta, Vec3(zero, zero, fsz), depth, ta, n)

    # Representative face: the one whose outward normal best matches the winning normal.
    xd = n.x * fsx
    yd = n.y * fsy
    zd = n.z * fsz
    use_x = xd > torch.maximum(yd, zd)
    use_y = (~use_x) & (yd > zd)
    use_z = ~(use_x | use_y)
    sel = lambda x, y, z: torch.where(use_x, x, torch.where(use_y, y, z))

    fn_dot_n = sel(xd, yd, zd)
    inv_fn_dot_n = 1.0 / torch.clamp_min(fn_dot_n, 1e-15)
    axis_dot_fn = sel(d.x * fsx, d.y * fsy, d.z * fsz)
    center_dot_fn = sel(a.x * fsx, a.y * fsy, a.z * fsz)
    face_offset = sel(hb.x, hb.y, hb.z)
    t_axis = axis_dot_fn * inv_fn_dot_n
    t_center = (center_dot_fn - face_offset) * inv_fn_dot_n

    unproj_axis = d - n * t_axis
    unproj_center = a - n * t_center
    ts_ax = torch.where(use_x, unproj_axis.y, unproj_axis.x)
    ts_ay = torch.where(use_z, unproj_axis.y, unproj_axis.z)
    ts_cx = torch.where(use_x, unproj_center.y, unproj_center.x)
    ts_cy = torch.where(use_z, unproj_center.y, unproj_center.z)
    eps_scale = torch.minimum(torch.maximum(hb.x, torch.maximum(hb.y, hb.z)),
                              torch.maximum(hl, r))
    eps = eps_scale * 1e-3
    half_u = eps + torch.where(use_x, hb.y, hb.x)
    half_v = eps + torch.where(use_z, hb.y, hb.z)

    inv_ax = -1.0 / torch.where(ts_ax.abs() < 1e-15, 1e-15, ts_ax)
    inv_ay = -1.0 / torch.where(ts_ay.abs() < 1e-15, 1e-15, ts_ay)
    tx0 = (ts_cx - half_u) * inv_ax
    tx1 = (ts_cx + half_u) * inv_ax
    ty0 = (ts_cy - half_v) * inv_ay
    ty1 = (ts_cy + half_v) * inv_ay
    min_x = torch.minimum(tx0, tx1)
    max_x = torch.maximum(tx0, tx1)
    min_y = torch.minimum(ty0, ty1)
    max_y = torch.maximum(ty0, ty1)
    big = 3.0e38
    fb_x = ts_ax.abs() < 1e-15
    fb_y = ts_ay.abs() < 1e-15
    in_x = ts_cx.abs() <= half_u
    in_y = ts_cy.abs() <= half_v
    min_x = torch.where(fb_x, torch.where(in_x, -big, big), min_x)
    max_x = torch.where(fb_x, torch.where(in_x, big, -big), max_x)
    min_y = torch.where(fb_y, torch.where(in_y, -big, big), min_y)
    max_y = torch.where(fb_y, torch.where(in_y, big, -big), max_y)
    face_min = torch.maximum(min_x, min_y)
    face_max = torch.minimum(max_x, max_y)
    t_min = clip(face_min, -hl, hl)
    t_max = clip(face_max, -hl, hl)
    has_interval = face_max >= face_min
    t_min = torch.where(has_interval, torch.minimum(t_min, ta), ta)
    t_max = torch.where(has_interval, torch.maximum(t_max, ta), ta)

    sep_min = t_center + t_axis * t_min
    sep_max = t_center + t_axis * t_max
    depth0 = r - sep_min
    depth1 = r - sep_max

    normal = orn_b.rotate(n)
    p0 = orn_b.rotate(d * t_min)
    p1 = orn_b.rotate(d * t_max)
    p0 = p0 + normal * (depth0 * 0.5 - r)
    p1 = p1 + normal * (depth1 * 0.5 - r)
    return _two_contacts(p0, p1, depth0, depth1, normal, t_max - t_min > 1e-7 * hl)


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


# ---- Triangle families (triangles are always the B side by type id; vertices in B's
# local frame). One-sidedness and boundary smoothing belong to the mesh narrow phase.


def _closest_on_triangle(p: Vec3, a: Vec3, b: Vec3, c: Vec3):
    """Closest point on triangle (a, b, c) to p, fully masked (Ericson 5.1.5): (point,
    region) with region 0:A, 1:B, 2:C, 3:AB, 4:AC, 5:BC, 6:face."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = ab.dot(ap)
    d2 = ac.dot(ap)
    bp = p - b
    d3 = ab.dot(bp)
    d4 = ac.dot(bp)
    cp = p - c
    d5 = ab.dot(cp)
    d6 = ac.dot(cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    safe = lambda x: torch.where(x.abs() > 1e-30, x, 1e-30)
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    t_ab = d1 / safe(d1 - d3)
    t_ac = d2 / safe(d2 - d6)
    t_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    inv_face = 1.0 / safe(va + vb + vc)
    v_f = vb * inv_face
    w_f = vc * inv_face

    # Priority select: the first region that holds wins, the face is the fallback.
    pt = a + ab * v_f + ac * w_f
    region = torch.full(p.x.shape, 6, dtype=torch.int32, device=p.x.device)
    for cond, point, rid in ((on_bc, b + (c - b) * t_bc, 5), (on_ac, a + ac * t_ac, 4),
                             (on_ab, a + ab * t_ab, 3), (in_c, c, 2), (in_b, b, 1),
                             (in_a, a, 0)):
        pt = pt.where(~cond, point)
        region = torch.where(cond, rid, region)
    return pt, region


def _tri_verts_local(params_b):
    return (Vec3(params_b[:, 0], params_b[:, 1], params_b[:, 2]),
            Vec3(params_b[:, 3], params_b[:, 4], params_b[:, 5]),
            Vec3(params_b[:, 6], params_b[:, 7], params_b[:, 8]))


def sphere_triangle(pos_ab: Vec3, orn_b: Quat, params_a, params_b) -> Manifold:
    """Sphere A vs triangle B (reference CollisionTasks/SphereTriangleTester.cs): the
    triangle's closest point to the sphere's centre; the normal is geometric
    (side-sensitive), so a manifold behind the face stays back-facing."""
    r = params_a[:, 0]
    va, vb, vc = _tri_verts_local(params_b)
    lc = orn_b.rotate_inverse(-1.0 * pos_ab)  # the sphere's centre in B's frame
    cp, region = _closest_on_triangle(lc, va, vb, vc)
    diff = lc - cp
    dist2 = diff.length_squared()
    dist = torch.sqrt(dist2.clamp_min(1e-30))
    fn = (vb - va).cross(vc - va).normalize()  # the winding (front) normal, B local
    n_local = (diff * (1.0 / dist)).where(dist2 > 1e-20, fn)
    depth = r - dist
    normal = orn_b.rotate(n_local)  # B→A
    contact = normal * -(r - 0.5 * depth)  # the sphere's surface toward the triangle
    return _single_contact(contact, depth, normal)._replace(
        feature=_col0(r.shape[0], region, 0, torch.int32, r.device))


def _seg_seg_closest(pa: Vec3, da: Vec3, hla, pb: Vec3, db_u: Vec3, hlb):
    """(t, s) of the closest points of segments {pa + t·da, |t| ≤ hla} and {pb + s·db_u,
    |s| ≤ hlb} (unit directions): the clamped quadratic, then mutual re-projection."""
    r = pb - pa
    a_dot_b = da.dot(db_u)
    da_r = da.dot(r)
    db_r = db_u.dot(r)
    denom = 1.0 - a_dot_b * a_dot_b
    t = torch.where(denom > 1e-7, _clip((da_r - a_dot_b * db_r) / denom.clamp_min(1e-7), hla),
                    0.0)
    s = _clip(db_u.dot(pa + da * t - pb), hlb)
    t = _clip(da.dot(pb + db_u * s - pa), hla)
    return t, s


def _clip(x, h):
    """``clip(x, -h, h)`` for a tensor ``h``."""
    return torch.minimum(torch.maximum(x, -h), h)


def capsule_triangle(pos_ab: Vec3, orn_a: Quat, orn_b: Quat, params_a, params_b) -> Manifold:
    """Capsule A vs triangle B (reference CollisionTasks/CapsuleTriangleTester.cs): the
    capsule's axis clipped to the prism of the triangle's edge planes (the face contact,
    signed depth), the 3 edge-segment pairs; a near-parallel face contact gives 2 contacts
    at the ends of the clip interval."""
    r, hl = params_a[:, 0], params_a[:, 1]
    N = r.shape[0]
    dev = r.device
    la, lb, lc_ = _tri_verts_local(params_b)
    v0 = pos_ab + orn_b.rotate(la)  # relative to A's centre, world orientation
    v1 = pos_ab + orn_b.rotate(lb)
    v2 = pos_ab + orn_b.rotate(lc_)
    d = orn_a.rotate(Vec3.full((N,), 0.0, 1.0, 0.0, device=dev))  # the capsule's axis
    fn = (v1 - v0).cross(v2 - v0).normalize()  # the winding (front) normal

    # The face candidate: the axis segment clipped to the triangle's edge-plane prism.
    big = 3.0e38
    t_lo = torch.full((N,), -big, dtype=torch.float32, device=dev)
    t_hi = torch.full((N,), big, dtype=torch.float32, device=dev)
    for ea, eb in ((v0, v1), (v1, v2), (v2, v0)):
        en = fn.cross(eb - ea)  # inward edge-plane normal
        c0 = en.dot(-1.0 * ea)  # the plane's value at the segment's centre (A's centre)
        slope = en.dot(d)
        # Points with c0 + slope·t >= 0 lie inside this plane.
        t_cross = -c0 / torch.where(slope.abs() > 1e-12, slope, 1e-12)
        par = slope.abs() <= 1e-12
        lo_k = torch.where(par, torch.where(c0 >= 0, -big, big),
                           torch.where(slope > 0, t_cross, -big))
        hi_k = torch.where(par, torch.where(c0 >= 0, big, -big),
                           torch.where(slope > 0, big, t_cross))
        t_lo = torch.maximum(t_lo, lo_k)
        t_hi = torch.minimum(t_hi, hi_k)
    t_lo_c = _clip(t_lo, hl)
    t_hi_c = _clip(t_hi, hl)
    face_valid = (t_hi >= t_lo) & (t_hi_c >= t_lo_c)
    # The face normal signed by the side of the capsule's centre, so that a manifold
    # behind the face stays back-facing.
    plane_off = fn.dot(v0)
    nf = fn * torch.where(plane_off <= 0.0, 1.0, -1.0)
    # Signed separation above the signed face plane at the clip ends; the deeper end is
    # the face candidate's depth.
    sep_lo = nf.dot(d) * t_lo_c - nf.dot(v0)
    sep_hi = nf.dot(d) * t_hi_c - nf.dot(v0)
    depth_face = torch.where(face_valid, r - torch.minimum(sep_lo, sep_hi), -big)

    def edge_candidate(ea, eb):
        mid = (ea + eb) * 0.5
        ed = eb - ea
        el = ed.length()
        eu = ed * (1.0 / el.clamp_min(1e-12))
        t, s = _seg_seg_closest(Vec3.zeros((N,), device=dev), d, hl, mid, eu, el * 0.5)
        pb_ = mid + eu * s
        dv = d * t - pb_
        dist = dv.length()
        # An axis through the edge: pushed out along fn.
        n_ = (dv * (1.0 / dist.clamp_min(1e-12))).where(dist > 1e-9, fn)
        return r - dist, n_, pb_, t

    depth, n, _, tpar = edge_candidate(v0, v1)
    fid = torch.full((N,), 4, dtype=torch.int32, device=dev)
    for (ea, eb), idc in (((v1, v2), 5), ((v2, v0), 6)):
        dc, nc, _, tc = edge_candidate(ea, eb)
        better = dc > depth
        depth = torch.where(better, dc, depth)
        n = nc.where(better, n)
        tpar = torch.where(better, tc, tpar)
        fid = torch.where(better, idc, fid)
    # The face wins where it is valid and at least as deep as the best edge pair.
    use_face = face_valid & (depth_face >= depth)
    depth = torch.where(use_face, depth_face, depth)
    n = nf.where(use_face, n)
    fid = torch.where(use_face, 0, fid)
    tpar = torch.where(use_face, torch.where(sep_lo <= sep_hi, t_lo_c, t_hi_c), tpar)

    # Two contacts where the face contact is near parallel (axis ⊥ n).
    two = (use_face & (d.dot(n).abs() < 0.3)
           & (t_hi_c - t_lo_c > 1e-6 * hl.clamp_min(1.0)))
    dep0 = torch.where(two, r - sep_lo, depth)
    dep1 = r - sep_hi
    p0 = d * torch.where(two, t_lo_c, tpar) + n * -(r - 0.5 * dep0)
    p1 = d * t_hi_c + n * -(r - 0.5 * dep1)
    f32 = torch.float32
    return Manifold(
        normal=n,
        offset_a=Vec3(_cols2(N, p0.x, p1.x, 0.0, f32, dev), _cols2(N, p0.y, p1.y, 0.0, f32, dev),
                      _cols2(N, p0.z, p1.z, 0.0, f32, dev)),
        depth=_cols2(N, dep0, dep1, 0.0, f32, dev),
        feature=_cols2(N, torch.where(two, 0, fid), 1, 0, torch.int32, dev),
        contact_mask=_cols2(N, True, two, False, torch.bool, dev),
    )


def box_triangle(pos_ab: Vec3, orn_a: Quat, orn_b: Quat, params_a, params_b) -> Manifold:
    """Box A vs triangle B (reference CollisionTasks/BoxTriangleTester.cs): SAT over the 3
    box faces, the triangle's face and 9 edge crosses; a face manifold from masked
    candidates in the box contact face's 2D frame (triangle vertices inside the
    rectangle, triangle edges × rectangle slabs, rectangle corners inside the triangle
    lifted onto its plane), reduced to ≤4 by the deepest/extremal rule; an edge winner
    gives its one closest-point contact."""
    N = params_a.shape[0]
    dev = params_a.device
    f32 = torch.float32
    ha = Vec3(params_a[:, 0], params_a[:, 1], params_a[:, 2])
    # The triangle's vertices in the box's (A) frame.
    q_ab = orn_a.conjugate().mul(orn_b)
    t_off = orn_a.rotate_inverse(pos_ab)
    la, lb, lc_ = _tri_verts_local(params_b)
    t0 = t_off + q_ab.rotate(la)
    t1 = t_off + q_ab.rotate(lb)
    t2 = t_off + q_ab.rotate(lc_)
    centroid = (t0 + t1 + t2) * (1.0 / 3.0)

    fn_raw = (t1 - t0).cross(t2 - t0)
    fn = fn_raw * (1.0 / fn_raw.length().clamp_min(1e-12))  # winding normal, A frame

    ones = torch.ones((N,), dtype=f32, device=dev)
    zeros = torch.zeros((N,), dtype=f32, device=dev)
    a_axes = [Vec3(ones, zeros, zeros), Vec3(zeros, ones, zeros), Vec3(zeros, zeros, ones)]
    ha_arr = [ha.x, ha.y, ha.z]

    def tri_max(axis: Vec3):
        return torch.maximum(axis.dot(t0), torch.maximum(axis.dot(t1), axis.dot(t2)))

    def box_ext(axis: Vec3):
        return axis.x.abs() * ha.x + axis.y.abs() * ha.y + axis.z.abs() * ha.z

    min_ext = torch.minimum(torch.minimum(ha.x, ha.y), ha.z)
    best_depth = torch.full((N,), 3.0e38, dtype=f32, device=dev)
    best_axis = Vec3.full((N,), 0.0, 1.0, 0.0, device=dev)
    best_id = torch.zeros((N,), dtype=torch.int32, device=dev)

    def consider(depth, axis, axis_id, bias=1.0):
        nonlocal best_depth, best_axis, best_id
        # B→A: away from the triangle's centroid (B's side, in A's frame).
        axis = axis.where(~(axis.dot(centroid) > 0.0), -1.0 * axis)
        penalty = (bias - 1.0) * (0.05 * min_ext + depth.abs())
        better = depth + penalty < best_depth
        best_depth = torch.where(better, depth, best_depth)
        best_axis = axis.where(better, best_axis)
        best_id = torch.where(better, axis_id, best_id)

    # The triangle's face first (id 0, preferred on ties: flat mesh ground stays stable).
    # Depth along unit n (B→A) = max_B(n·p) − min_A(n·p) = max_k n·t_k + Σ|n_i|h_i.
    n_tri = fn.where(fn.dot(centroid) < 0.0, -1.0 * fn)
    consider(tri_max(n_tri) + box_ext(n_tri), n_tri, 0)
    for i in range(3):  # the box's face axes (ids 1-3)
        axis = a_axes[i]
        depth = tri_max(axis.where(axis.dot(centroid) <= 0, -1.0 * axis)) + ha_arr[i]
        consider(depth, axis, 1 + i, bias=1.0 + 1e-3)
    edges = [(t0, t1), (t1, t2), (t2, t0)]
    for i in range(3):  # edge crosses (ids 4-12)
        for j, (ea, eb) in enumerate(edges):
            raw = a_axes[i].cross(eb - ea)
            ln = raw.length()
            ok = ln > 1e-7
            axis = raw * torch.where(ok, 1.0 / ln.clamp_min(1e-7), 0.0)
            cal = axis.where(axis.dot(centroid) <= 0, -1.0 * axis)
            depth = torch.where(ok, tri_max(cal) + box_ext(cal), 3.0e38)
            consider(depth, cal, 4 + i * 3 + j, bias=1.05)

    n_local = best_axis  # B→A, A frame
    face_contact = best_id < 4

    # The face manifold in the (u, v) frame of the box face most aligned with −n.
    rdim = torch.argmax(torch.stack([n_local.x.abs(), n_local.y.abs(), n_local.z.abs()], -1), -1)
    u_ax = _pick(a_axes, (rdim + 1) % 3)
    v_ax = _pick(a_axes, (rdim + 2) % 3)
    h_u = _pick_h(ha, (rdim + 1) % 3)
    h_v = _pick_h(ha, (rdim + 2) % 3)

    tri_pts = [t0, t1, t2]
    vu = [u_ax.dot(p) for p in tri_pts]
    vv = [v_ax.dot(p) for p in tri_pts]

    eps = 1e-6
    cand_pts, cand_mask = [], []
    for m in range(3):  # (a) triangle vertices inside the rectangle
        cand_pts.append(tri_pts[m])
        cand_mask.append((vu[m].abs() <= h_u + eps) & (vv[m].abs() <= h_v + eps))
    for m in range(3):  # (b) triangle edges × rectangle slabs (3 × 4)
        p0, p1 = tri_pts[m], tri_pts[(m + 1) % 3]
        u0, u1 = vu[m], vu[(m + 1) % 3]
        v0_, v1_ = vv[m], vv[(m + 1) % 3]
        for p_idx, (c0, c1, lim, o0, o1, olim) in enumerate((
                (u0, u1, h_u, v0_, v1_, h_v), (u0, u1, -h_u, v0_, v1_, h_v),
                (v0_, v1_, h_v, u0, u1, h_u), (v0_, v1_, -h_v, u0, u1, h_u))):
            denom = c1 - c0
            frac = (lim - c0) / torch.where(denom.abs() > 1e-9, denom, 1e-9)
            valid = (denom.abs() > 1e-9) & (frac >= 0.0) & (frac <= 1.0)
            valid = valid & ((o0 + (o1 - o0) * frac).abs() <= olim + eps)
            cand_pts.append(p0 + (p1 - p0) * frac)
            cand_mask.append(valid)
    # (c) rectangle corners inside the triangle (2D), lifted onto the triangle's plane.
    n_dim = _pick(a_axes, rdim)
    plane_d = fn.dot(t0)
    denom_w = fn.dot(n_dim)
    area2 = (vu[1] - vu[0]) * (vv[2] - vv[0]) - (vu[2] - vu[0]) * (vv[1] - vv[0])
    winding = torch.sign(torch.where(area2 == 0, 1.0, area2))
    for ci, (su, sv) in enumerate([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)]):
        cu = su * h_u
        cv = sv * h_v
        inside = torch.ones((N,), dtype=torch.bool, device=dev)
        for m in range(3):
            eu = vu[(m + 1) % 3] - vu[m]
            ev = vv[(m + 1) % 3] - vv[m]
            inside = inside & ((eu * (cv - vv[m]) - ev * (cu - vu[m])) * winding >= -eps)
        base = u_ax * cu + v_ax * cv
        w = (plane_d - fn.dot(base)) / torch.where(denom_w.abs() > 1e-9, denom_w, 1e-9)
        cand_pts.append(base + n_dim * w)
        cand_mask.append(inside & (denom_w.abs() > 1e-9))

    pts = Vec3(*(torch.stack([getattr(p, c) for p in cand_pts], -1) for c in "xyz"))
    cmask = torch.stack(cand_mask, -1)
    K = cmask.shape[1]
    # The candidates' feature ids, made on the device (a tensor from a host list would be
    # a host-to-device copy, a sync, every step).
    cfeat = torch.cat([torch.arange(lo, hi, dtype=torch.int32, device=dev)
                       for lo, hi in ((0, 3), (8, 20), (24, 28))]).expand(N, K)

    # Each candidate lies on the triangle: depth = Σ|n_i|h_i + n·p.
    np_dot = (n_local.x[:, None] * pts.x + n_local.y[:, None] * pts.y
              + n_local.z[:, None] * pts.z)
    depth_pts = box_ext(n_local)[:, None] + np_dot
    neg_big = -3.0e38
    kk = torch.arange(K, device=dev)[None, :]

    def pick_max(scores, taken):
        return torch.argmax(torch.where(taken, neg_big, scores), -1)

    taken = ~cmask
    i0 = pick_max(torch.where(cmask, depth_pts, neg_big), taken)
    p0 = Vec3(_take(pts.x, i0), _take(pts.y, i0), _take(pts.z, i0))
    taken = taken | (kk == i0[:, None])
    d0 = Vec3(pts.x - p0.x[:, None], pts.y - p0.y[:, None], pts.z - p0.z[:, None])
    i1 = pick_max(d0.length_squared(), taken)
    p1 = Vec3(_take(pts.x, i1), _take(pts.y, i1), _take(pts.z, i1))
    taken = taken | (kk == i1[:, None])
    edge_v = p1 - p0
    cr = Vec3(edge_v.y[:, None] * d0.z - edge_v.z[:, None] * d0.y,
              edge_v.z[:, None] * d0.x - edge_v.x[:, None] * d0.z,
              edge_v.x[:, None] * d0.y - edge_v.y[:, None] * d0.x)
    side = cr.x * n_local.x[:, None] + cr.y * n_local.y[:, None] + cr.z * n_local.z[:, None]
    i2 = pick_max(side, taken)
    taken = taken | (kk == i2[:, None])
    i3 = pick_max(-side, taken)

    sel = torch.stack([i0, i1, i2, i3], -1)
    valid_cols = list(select_cols(cmask, sel).unbind(-1))
    for a_i in range(1, 4):
        for b_i in range(a_i):
            valid_cols[a_i] = valid_cols[a_i] & ~(sel[:, a_i] == sel[:, b_i])
    valid_sel = torch.stack(valid_cols, -1)
    c_pts = Vec3(select_cols(pts.x, sel), select_cols(pts.y, sel), select_cols(pts.z, sel))
    c_depth = select_cols(torch.where(cmask, depth_pts, 0.0), sel)
    c_feat = select_cols(cfeat, sel)

    # The edge-edge winner: one closest-point contact.
    ei = torch.div(best_id - 4, 3, rounding_mode="floor")
    ej = torch.remainder(best_id - 4, 3)
    a_dir = _pick(a_axes, ei.clamp_min(0))
    to_b = -1.0 * n_local
    corner_a = Vec3(torch.where(ei == 0, 0.0, torch.sign(to_b.x) * ha.x),
                    torch.where(ei == 1, 0.0, torch.sign(to_b.y) * ha.y),
                    torch.where(ei == 2, 0.0, torch.sign(to_b.z) * ha.z))
    e_sel = ej.clamp(0, 2)
    ea = _pick([t0, t1, t2], e_sel)
    eb = _pick([t1, t2, t0], e_sel)
    emid = (ea + eb) * 0.5
    ed = eb - ea
    el = ed.length()
    eu_ = ed * (1.0 / el.clamp_min(1e-12))
    # The box edge is 2·h[ei] long; clamped by the shared segment-segment helper.
    h_edge = torch.where(ei == 0, ha.x, torch.where(ei == 1, ha.y, ha.z))
    t_par, _ = _seg_seg_closest(corner_a, a_dir, h_edge, emid, eu_, el * 0.5)
    edge_pt = corner_a + a_dir * t_par

    fm = face_contact[:, None]
    out_pts = Vec3(*(torch.where(fm, getattr(c_pts, c), _col0(N, getattr(edge_pt, c), 0.0, f32, dev))
                     for c in "xyz"))
    out_depth = torch.where(fm, c_depth, _col0(N, best_depth, 0.0, f32, dev))
    out_feat = torch.where(fm, c_feat, 64 + best_id[:, None])
    out_mask = torch.where(fm, valid_sel, _col0(N, True, False, torch.bool, dev))

    ma = orn_a.to_matrix()
    world_pts = Vec3(
        ma.rx.x[:, None] * out_pts.x + ma.ry.x[:, None] * out_pts.y + ma.rz.x[:, None] * out_pts.z,
        ma.rx.y[:, None] * out_pts.x + ma.ry.y[:, None] * out_pts.y + ma.rz.y[:, None] * out_pts.z,
        ma.rx.z[:, None] * out_pts.x + ma.ry.z[:, None] * out_pts.y + ma.rz.z[:, None] * out_pts.z,
    )
    return Manifold(normal=orn_a.rotate(n_local), offset_a=world_pts, depth=out_depth,
                    feature=out_feat.to(torch.int32), contact_mask=out_mask)
