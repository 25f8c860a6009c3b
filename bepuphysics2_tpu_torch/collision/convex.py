"""Generic convex-convex collision: support mappings and masked GJK/MPR over the pair array.

Counterpart of ``bepuphysics2_tpu/collision/convex.py``: the analytic testers
(``testers.py``) cover the sphere, capsule, box and triangle families, and this one
generic path covers every other convex pair (cylinders, hulls, custom shapes):

- **GJK** (distance, ``GJK_ITERS`` fixed iterations, per-record convergence masks) for the
  separated and speculative regime: closest points, separating normal, negative depth;
- **MPR** (Minkowski portal refinement, ``MPR_ITERS`` fixed iterations) for the
  penetrating regime: penetration normal and depth;
- the manifold from supports sampled under small tilts of the contact normal (up to 4
  contacts with stable feature ids), standing in for the reference's face clipping.

Everything is branch-free over the records, with the JAX module's fixed iteration counts,
so nothing waits for the device. Supports are taken in A's local frame with B's pose
expressed there, as a core shape plus a radius margin (spheres and capsules carry their
radius as margin).

A hull's support gathers its vertices from the registry's pool through a padded table of
pool rows per record (``ShapeData.hull_rows``: the vertex count of the largest hull wide,
-1 past a hull's own count) and takes the first maximal vertex in pool order, as the JAX
package's windowed scan does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..shapes.custom import CUSTOM_SUPPORTS
from ..shapes.registry import CAPSULE, CONVEX_HULL, CYLINDER, SPHERE, TRIANGLE
from ..utils.packing import select_col
from ..utils.vec import Quat, Vec3, build_orthonormal_basis
from .manifold import Manifold

GJK_ITERS = 24
MPR_ITERS = 24
_NEG = -3.0e38


def support_core(stype, params, hull_points: Optional[Vec3], hull_rows, d: Vec3,
                 custom_ids=None):
    """Support point of the shape's core (margin removed) in its local frame for the
    direction ``d`` (need not be unit): (point: Vec3, margin).

    - SPHERE: the origin, margin = radius; CAPSULE: the segment, margin = radius
    - BOX: the sign corner; CYLINDER: rim or cap; TRIANGLE: the best of the 3 vertices
    - CONVEX_HULL: the first maximal vertex of the record's pool rows (``hull_rows``,
      (..., H) int, -1 past its count), when ``hull_points`` is given
    - custom types: their registered support functions (``custom_ids``; every registered
      one where None)
    """
    zero = torch.zeros_like(d.x)
    p0, p1, p2 = params[..., 0], params[..., 1], params[..., 2]

    sphere_pt = Vec3(zero, zero, zero)
    capsule_pt = Vec3(zero, torch.where(d.y >= 0.0, p1, -p1), zero)
    box_pt = Vec3(torch.where(d.x >= 0.0, p0, -p0), torch.where(d.y >= 0.0, p1, -p1),
                  torch.where(d.z >= 0.0, p2, -p2))

    # Cylinder: the radial direction in xz and the signed cap.
    horiz = torch.sqrt(d.x * d.x + d.z * d.z)
    inv_h = torch.where(horiz > 1e-12, 1.0 / horiz.clamp_min(1e-12), 0.0)
    cyl_pt = Vec3(d.x * inv_h * p0, torch.where(d.y >= 0.0, p1, -p1), d.z * inv_h * p0)

    va = Vec3(p0, p1, p2)
    vb = Vec3(params[..., 3], params[..., 4], params[..., 5])
    vc = Vec3(params[..., 6], params[..., 7], params[..., 8])
    da_, db_, dc_ = d.dot(va), d.dot(vb), d.dot(vc)
    tri_pt = va.where((da_ >= db_) & (da_ >= dc_), vb.where(db_ >= dc_, vc))

    pt = box_pt
    pt = sphere_pt.where(stype == SPHERE, pt)
    pt = capsule_pt.where(stype == CAPSULE, pt)
    pt = cyl_pt.where(stype == CYLINDER, pt)
    pt = tri_pt.where(stype == TRIANGLE, pt)
    if hull_points is not None:
        live = hull_rows >= 0
        rows = hull_rows.clamp_min(0).long()
        px, py, pz = hull_points.x[rows], hull_points.y[rows], hull_points.z[rows]
        dots = d.x[..., None] * px + d.y[..., None] * py + d.z[..., None] * pz
        best = torch.argmax(torch.where(live, dots, _NEG), dim=-1)
        hull_pt = Vec3(select_col(px, best), select_col(py, best), select_col(pz, best))
        pt = hull_pt.where(stype == CONVEX_HULL, pt)
    margin = torch.where(stype == SPHERE, p0, torch.where(stype == CAPSULE, p0, 0.0))

    for tid in (CUSTOM_SUPPORTS if custom_ids is None else custom_ids):
        cpt, cmargin = CUSTOM_SUPPORTS[tid](params, d)
        sel = stype == tid
        pt = cpt.where(sel, pt)
        margin = torch.where(sel, cmargin, margin)
    return pt, margin


class SupportCtx(NamedTuple):
    """Per-record data to evaluate Minkowski-difference supports in A's local frame."""

    type_a: torch.Tensor
    params_a: torch.Tensor
    type_b: torch.Tensor
    params_b: torch.Tensor
    orn_ab: Quat  # rotation taking B-local vectors to A's frame
    pos_ab: Vec3  # B's centre in A's frame
    hull_points: Optional[Vec3]  # the hull pool, or None where no hull can occur
    hull_rows_a: Optional[torch.Tensor]  # (N, H) pool rows of A's hull, -1 padded
    hull_rows_b: Optional[torch.Tensor]
    custom_ids: Optional[tuple] = None  # the custom types to evaluate (None: all)

    def support_a(self, d: Vec3):
        return support_core(self.type_a, self.params_a, self.hull_points, self.hull_rows_a,
                            d, self.custom_ids)

    def support_b(self, d: Vec3):
        return support_core(self.type_b, self.params_b, self.hull_points, self.hull_rows_b,
                            d, self.custom_ids)


def minkowski_support(ctx: SupportCtx, d: Vec3):
    """Support of (A − B) in direction d (A's frame): (w, the point on A's core, the sum
    of the margins)."""
    sa, ma = ctx.support_a(d)
    sb_local, mb = ctx.support_b(ctx.orn_ab.rotate_inverse(-1.0 * d))
    sb = ctx.orn_ab.rotate(sb_local) + ctx.pos_ab
    return sa - sb, sa, ma + mb


def _cols(n, values: dict, fill, dtype, device):
    """(n, 4) of ``fill`` with column i set to ``values[i]``."""
    out = torch.full((n, 4), fill, dtype=dtype, device=device)
    for i, v in values.items():
        out[:, i] = v
    return out


def _closest_on_simplex(pts, mask):
    """Distance subalgorithm by masked projection onto every sub-simplex of ≤4 points.
    pts: 4 Vec3 of (N,), mask: (N, 4) live points. Returns (closest: Vec3, barycentric
    (N, 4), kept points (N, 4)) of the nearest feature."""
    N = pts[0].x.shape[0]
    dev = pts[0].x.device
    f32 = torch.float32
    best_d2 = torch.full((N,), 3.0e38, dtype=f32, device=dev)
    best_bary = torch.zeros((N, 4), dtype=f32, device=dev)
    best_keep = torch.zeros((N, 4), dtype=torch.bool, device=dev)

    def consider(d2, bary, keep, ok):
        nonlocal best_d2, best_bary, best_keep
        better = ok & (d2 < best_d2)
        best_d2 = torch.where(better, d2, best_d2)
        best_bary = torch.where(better[:, None], bary, best_bary)
        best_keep = torch.where(better[:, None], keep, best_keep)

    keep_of = lambda *ids: _cols(N, {i: True for i in ids}, False, torch.bool, dev)

    for i in range(4):  # vertices
        consider(pts[i].length_squared(), _cols(N, {i: 1.0}, 0.0, f32, dev), keep_of(i),
                 mask[:, i])

    for i in range(4):  # edges
        for j in range(i + 1, 4):
            a, b = pts[i], pts[j]
            ab = b - a
            denom = ab.length_squared()
            t = torch.clamp(-a.dot(ab) / denom.clamp_min(1e-30), 0.0, 1.0)
            p = a + ab * t
            interior = (t > 0.0) & (t < 1.0)
            ok = mask[:, i] & mask[:, j] & (denom > 1e-30) & interior
            consider(p.length_squared(), _cols(N, {i: 1.0 - t, j: t}, 0.0, f32, dev),
                     keep_of(i, j), ok)

    for i in range(4):  # triangle faces
        for j in range(i + 1, 4):
            for k in range(j + 1, 4):
                a, b, c = pts[i], pts[j], pts[k]
                ab = b - a
                ac = c - a
                n = ab.cross(ac)
                nn = n.length_squared()
                # The origin projected onto the plane {x: n·x = n·a}: p = n (n·a)/|n|².
                p = n * (a.dot(n) / nn.clamp_min(1e-30))
                ap = p - a
                d00 = ab.dot(ab)
                d01 = ab.dot(ac)
                d11 = ac.dot(ac)
                d20 = ap.dot(ab)
                d21 = ap.dot(ac)
                den = d00 * d11 - d01 * d01
                sden = torch.sign(torch.where(den == 0, 1.0, den))
                aden = den.abs().clamp_min(1e-30)
                v = (d11 * d20 - d01 * d21) / aden * sden
                w = (d00 * d21 - d01 * d20) / aden * sden
                u = 1.0 - v - w
                interior = (u > 0.0) & (v > 0.0) & (w > 0.0)
                ok = mask[:, i] & mask[:, j] & mask[:, k] & (nn > 1e-30) & interior
                consider(p.length_squared(), _cols(N, {i: u, j: v, k: w}, 0.0, f32, dev),
                         keep_of(i, j, k), ok)

    closest = Vec3(*(sum(best_bary[:, i] * getattr(pts[i], c) for i in range(4)) for c in "xyz"))
    return closest, best_bary, best_keep


def _same_side(a, b, c, d):
    n_f = (b - a).cross(c - a)
    return (n_f.dot(-1.0 * a)) * (n_f.dot(d - a)) >= 0.0


def gjk_closest(ctx: SupportCtx):
    """GJK distance between the cores: (dist, unit normal B→A, the point on A's core,
    margin sum). For overlapping cores dist → ~0 and the normal degrades; the caller
    takes MPR's there."""
    n_rec = ctx.type_a.shape[0]
    dev = ctx.type_a.device
    d0 = (-1.0 * ctx.pos_ab).where(ctx.pos_ab.length_squared() > 1e-12,
                                   Vec3.full((n_rec,), 0.0, 1.0, 0.0, device=dev))
    w0, pa0, margin = minkowski_support(ctx, d0)

    z = Vec3.zeros((n_rec,), device=dev)
    pts = [w0, z, z, z]
    pas = [pa0, z, z, z]
    mask = _cols(n_rec, {0: True}, False, torch.bool, dev)
    done = torch.zeros((n_rec,), dtype=torch.bool, device=dev)
    slots = torch.arange(4, device=dev)[None, :]
    for _ in range(GJK_ITERS):
        closest, _, keep = _closest_on_simplex(pts, mask)
        dist2 = closest.length_squared()
        w, pa, _ = minkowski_support(ctx, -1.0 * closest)  # toward the origin
        # Converged: the new support makes no progress toward the origin.
        progress = (-1.0 * w.dot(closest) + dist2) > 1e-6 * dist2.clamp_min(1e-6)
        done = done | (~progress) | (dist2 < 1e-12)
        # w goes into the first slot the nearest feature does not keep.
        free_slot = torch.argmin(keep.to(torch.int32), dim=-1)
        write = (slots == free_slot[:, None]) & ~done[:, None]
        pts = [w.where(write[:, i], pts[i]) for i in range(4)]
        pas = [pa.where(write[:, i], pas[i]) for i in range(4)]
        mask = torch.where(done[:, None], mask, keep | write)
        if dev.type == "cpu" and bool(done.all()):
            break  # nothing changes any more (done is absorbing); the card never reads it

    closest, bary, keep = _closest_on_simplex(pts, mask)
    dist = closest.length()
    # The origin inside the final tetrahedron means overlap (the subalgorithm only sees
    # faces). A planar Minkowski difference (a sphere or capsule core against a triangle)
    # can pick up a duplicate fourth support whose flat tetrahedron passes every side
    # test, so the tetrahedron must have volume relative to its edges.
    e1, e2, e3 = pts[1] - pts[0], pts[2] - pts[0], pts[3] - pts[0]
    vol = e1.cross(e2).dot(e3)
    m2 = torch.maximum(e1.length_squared(),
                       torch.maximum(e2.length_squared(), e3.length_squared()))
    nondegenerate = vol.abs() > 1e-6 * m2 * torch.sqrt(m2.clamp_min(1e-30))
    contained = (mask.all(-1) & nondegenerate
                 & _same_side(pts[0], pts[1], pts[2], pts[3])
                 & _same_side(pts[0], pts[1], pts[3], pts[2])
                 & _same_side(pts[0], pts[2], pts[3], pts[1])
                 & _same_side(pts[1], pts[2], pts[3], pts[0]))
    dist = torch.where(contained, 0.0, dist)
    # closest is the point of A − B nearest the origin: A lies on its side, so it points
    # B→A.
    inv = torch.where(dist > 1e-9, 1.0 / dist.clamp_min(1e-9), 0.0)
    normal = closest * inv
    point_a = Vec3(*(sum(bary[:, i] * getattr(pas[i], c) for i in range(4)) for c in "xyz"))
    return dist, normal, point_a, margin


def mpr_penetration(ctx: SupportCtx):
    """MPR (XenoCollide style): penetration normal (pointing out of the Minkowski
    difference through the origin ray, A's frame) and core depth for overlapping cores;
    portal discovery and refinement with fixed iterations, fully masked."""
    n_rec = ctx.type_a.shape[0]
    dev = ctx.type_a.device
    # An interior point of A − B: A's centre minus B's.
    v0 = -1.0 * ctx.pos_ab
    degenerate0 = v0.length_squared() < 1e-10
    v0 = v0.where(~degenerate0, Vec3.full((n_rec,), 1e-3, 1.3e-3, 0.7e-3, device=dev))

    def pierce(a: Vec3, b: Vec3, c: Vec3):
        """Does the ray from v0 through the origin cross triangle (a, b, c)? The three
        tetrahedra det(x − v0, y − v0, −v0) share a sign."""
        ra, rb, rc = a - v0, b - v0, c - v0
        ro = -1.0 * v0
        s1 = ra.cross(rb).dot(ro)
        s2 = rb.cross(rc).dot(ro)
        s3 = rc.cross(ra).dot(ro)
        return (((s1 >= 0) & (s2 >= 0) & (s3 >= 0))
                | ((s1 <= 0) & (s2 <= 0) & (s3 <= 0)))

    # The first portal.
    v1, pa1, margin = minkowski_support(ctx, -1.0 * v0)
    d2 = v1.cross(v0)
    deg2 = d2.length_squared() < 1e-12
    fallback, _ = build_orthonormal_basis(v0.normalize())
    d2 = d2.where(~deg2, fallback)
    v2, pa2, _ = minkowski_support(ctx, d2)
    d3 = (v1 - v0).cross(v2 - v0)
    d3 = d3.where(~(d3.dot(-1.0 * v0) < 0.0), -1.0 * d3)  # toward the origin's side
    v3, pa3, _ = minkowski_support(ctx, d3)

    # Discovery: rotate the portal's vertices through fresh supports until the origin
    # ray crosses it.
    for _ in range(6):
        ok = pierce(v1, v2, v3)
        d_new = (v3 - v0).cross(v1 - v0)
        d_new = d_new.where(~(d_new.dot(-1.0 * v0) < 0.0), -1.0 * d_new)
        v_new, pa_new, _ = minkowski_support(ctx, d_new)
        v2, pa2, v3, pa3 = (v3.where(~ok, v2), pa3.where(~ok, pa2), v_new.where(~ok, v3),
                            pa_new.where(~ok, pa3))

    for _ in range(MPR_ITERS):
        n = (v2 - v1).cross(v3 - v1)
        n = n.where(n.dot(v1 - v0) >= 0.0, -1.0 * n)
        v4, pa4, _ = minkowski_support(ctx, n.normalize())
        # Which sub-portal does the origin ray cross once v4 is in? (v4, v1, v2) drops v3;
        # (v4, v2, v3) drops v1; otherwise (v4, v3, v1), which drops v2.
        drop3 = pierce(v4, v1, v2)
        drop1 = (~drop3) & pierce(v4, v2, v3)
        drop2 = ~drop1 & ~drop3
        v1, pa1 = v4.where(drop1, v1), pa4.where(drop1, pa1)
        v2, pa2 = v4.where(drop2, v2), pa4.where(drop2, pa2)
        v3, pa3 = v4.where(drop3, v3), pa4.where(drop3, pa3)

    # The final portal: its outward normal is the penetration direction and the depth
    # the distance of its plane from the origin.
    n = (v2 - v1).cross(v3 - v1)
    n = n.where(n.dot(v1 - v0) >= 0.0, -1.0 * n)
    nn_len = n.length()
    n_unit = n * torch.where(nn_len > 1e-12, 1.0 / nn_len.clamp_min(1e-12), 0.0)
    depth_core = v1.dot(n_unit)
    # The point on A: the portal's A points blended by the area coordinates of the
    # origin projected onto the portal plane.
    p = n_unit * depth_core
    ab = v2 - v1
    ac = v3 - v1
    ap = p - v1
    d00 = ab.dot(ab)
    d01 = ab.dot(ac)
    d11 = ac.dot(ac)
    d20 = ap.dot(ab)
    d21 = ap.dot(ac)
    den = d00 * d11 - d01 * d01
    safe = den.abs() > 1e-20
    inv_den = torch.where(safe, 1.0 / torch.where(safe, den, 1.0), 0.0)
    w2 = torch.clamp((d11 * d20 - d01 * d21) * inv_den, 0.0, 1.0)
    w3 = torch.clamp((d00 * d21 - d01 * d20) * inv_den, 0.0, 1.0)
    w1 = torch.clamp(1.0 - w2 - w3, 0.0, 1.0)
    point_a = Vec3(pa1.x * w1 + pa2.x * w2 + pa3.x * w3,
                   pa1.y * w1 + pa2.y * w2 + pa3.y * w3,
                   pa1.z * w1 + pa2.z * w2 + pa3.z * w3)
    return depth_core, n_unit, point_a, margin


def generic_convex_manifold(ctx: SupportCtx, orn_a: Quat) -> Manifold:
    """The manifold of every record from GJK, MPR and the tilted-normal samples, in world
    orientation relative to A's centre."""
    n_rec = ctx.type_a.shape[0]
    dev = ctx.type_a.device
    dist, n_gjk, pa_gjk, margin = gjk_closest(ctx)
    pen_depth, n_mpr, pa_mpr, _ = mpr_penetration(ctx)

    # A separating plane along GJK's direction: MPR's portal degenerates for flat shapes
    # (triangles) and can report a deep penetration of a pair that is clearly apart. A
    # positive support gap along n_gjk (min over A of a·n minus max over B of b·n)
    # proves separation and overrides MPR; where GJK only stalled on a penetrating pair
    # the gap is ≤ 0 and MPR still decides.
    sa_cert_l, _ = ctx.support_a(-1.0 * n_gjk)
    sb_cert_l, _ = ctx.support_b(ctx.orn_ab.rotate_inverse(n_gjk))
    gap_gjk = sa_cert_l.dot(n_gjk) - (ctx.orn_ab.rotate(sb_cert_l) + ctx.pos_ab).dot(n_gjk)
    certified_separated = gap_gjk > 1e-6

    # Overlapping: GJK reaches ~0 or MPR's portal plane lies beyond the origin (MPR's sign
    # is the containment test), unless a separating plane was found above. MPR's normal
    # points out through the origin ray, A→B: negated for the B→A convention.
    overlapping = ((dist < 1e-6) | (pen_depth > 0.0)) & ~certified_separated
    normal_local = (-1.0 * n_mpr).where(overlapping, n_gjk)
    # Depth with the margins: separated margin − dist, penetrating core depth + margin.
    depth0 = torch.where(overlapping, pen_depth + margin, margin - dist)
    pa0 = pa_mpr.where(overlapping, pa_gjk)
    # A's share of the margin pushes the core point toward B (the offsets feed lever arms).
    contact0 = pa0 - normal_local * (0.5 * margin)

    # More contacts: supports of both shapes under small tilts of the normal. A tilted
    # support that stays near the contact plane lies on the flat contact patch (a
    # cylinder's cap rim, a box face's corner); far features fail the depth gate.
    t1, t2 = build_orthonormal_basis(normal_local)
    tilt = 0.15
    # The support planes along the shared normal: A's toward B along −n, B's toward A.
    sb_plane_l, _ = ctx.support_b(ctx.orn_ab.rotate_inverse(normal_local))
    sb_plane = (ctx.orn_ab.rotate(sb_plane_l) + ctx.pos_ab).dot(normal_local)
    sa_plane_l, _ = ctx.support_a(-1.0 * normal_local)
    sa_plane = sa_plane_l.dot(normal_local)

    cand_pts, cand_depth, cand_ok = [], [], []
    tilts = [t1 * tilt, -1.0 * (t1 * tilt), t2 * tilt, -1.0 * (t2 * tilt)]
    for k, tv in enumerate(tilts):
        # On A: direction −(n + tilt), A's surface toward B.
        sa_k, _ = ctx.support_a(-1.0 * (normal_local + tv))
        d_a = (sb_plane - sa_k.dot(normal_local)) + margin
        cand_pts.append(sa_k - normal_local * (0.5 * margin))
        cand_depth.append(d_a)
        cand_ok.append((d_a - depth0).abs() < 0.05 + 0.1 * depth0.abs())
        # On B: direction (n + tilt), in B's frame.
        sb_k_l, _ = ctx.support_b(ctx.orn_ab.rotate_inverse(normal_local + tv))
        sb_k = ctx.orn_ab.rotate(sb_k_l) + ctx.pos_ab
        d_b = (sb_k.dot(normal_local) - sa_plane) + margin
        cand_pts.append(sb_k - normal_local * (sb_k.dot(normal_local) - sa_plane + 0.5 * margin))
        cand_depth.append(d_b)
        cand_ok.append((d_b - depth0).abs() < 0.05 + 0.1 * depth0.abs())

    K = len(cand_pts)
    cpx = torch.stack([p.x for p in cand_pts], -1)
    cpy = torch.stack([p.y for p in cand_pts], -1)
    cpz = torch.stack([p.z for p in cand_pts], -1)
    cdep = torch.stack(cand_depth, -1)
    cok = torch.stack(cand_ok, -1)
    # Feature ids 10 + k (A's samples) and 20 + k (B's), made on the device: a tensor
    # from a host list would be a host-to-device copy, a sync, every step.
    kk = torch.arange(K, dtype=torch.int32, device=dev)
    cft = torch.where(kk % 2 == 0, 10 + kk // 2, 20 + kk // 2).expand(n_rec, K)

    # The tangential gate: depth alone cannot reject far coplanar features (a large
    # ground face's corners lie on the contact plane). A candidate of one shape counts
    # only inside the other's tangential footprint: the (t1, t2) box of the other's own
    # candidates and the central contact. Candidates alternate A, B, A, B, ...
    cu = cpx * t1.x[:, None] + cpy * t1.y[:, None] + cpz * t1.z[:, None]
    cv = cpx * t2.x[:, None] + cpy * t2.y[:, None] + cpz * t2.z[:, None]
    u0 = contact0.dot(t1)
    v0 = contact0.dot(t2)
    is_a = kk % 2 == 0
    pad = 0.05 + 0.1 * depth0.abs()[:, None]
    big_u = 3.0e38

    def bbox(side_mask):
        sel_ok = cok & side_mask[None, :]
        umin = torch.where(sel_ok, cu, big_u).amin(-1)
        umax = torch.where(sel_ok, cu, -big_u).amax(-1)
        vmin = torch.where(sel_ok, cv, big_u).amin(-1)
        vmax = torch.where(sel_ok, cv, -big_u).amax(-1)
        return (torch.minimum(umin, u0), torch.maximum(umax, u0),
                torch.minimum(vmin, v0), torch.maximum(vmax, v0))

    def inside(box):
        umin, umax, vmin, vmax = box
        return ((cu >= umin[:, None] - pad) & (cu <= umax[:, None] + pad)
                & (cv >= vmin[:, None] - pad) & (cv <= vmax[:, None] + pad))

    in_a, in_b = inside(bbox(is_a)), inside(bbox(~is_a))
    cok = cok & torch.where(is_a[None, :], in_b, in_a)
    # Drop candidates too close to contact0 or to an earlier kept one (greedy, in order).
    min_sep2 = 1e-4
    d0x = cpx - contact0.x[:, None]
    d0y = cpy - contact0.y[:, None]
    d0z = cpz - contact0.z[:, None]
    cok = cok & (d0x * d0x + d0y * d0y + d0z * d0z > min_sep2)
    ok_cols = list(cok.unbind(-1))
    for i_c in range(K):
        for j_c in range(i_c + 1, K):
            dx = cpx[:, i_c] - cpx[:, j_c]
            dy = cpy[:, i_c] - cpy[:, j_c]
            dz = cpz[:, i_c] - cpz[:, j_c]
            close = dx * dx + dy * dy + dz * dz <= min_sep2
            ok_cols[j_c] = ok_cols[j_c] & ~(close & ok_cols[i_c])
    cok = torch.stack(ok_cols, -1)

    # Up to 3 more contacts: valid first, then deepest.
    slots_p = [contact0]
    slots_d = [depth0]
    slots_f = [torch.zeros((n_rec,), dtype=torch.int32, device=dev)]
    slots_m = [torch.ones((n_rec,), dtype=torch.bool, device=dev)]
    taken = ~cok
    for _ in range(3):
        pick = torch.argmax(torch.where(taken, _NEG, cdep), dim=-1)
        slots_p.append(Vec3(select_col(cpx, pick), select_col(cpy, pick), select_col(cpz, pick)))
        slots_d.append(select_col(cdep, pick))
        slots_f.append(select_col(cft, pick))
        slots_m.append(select_col(~taken, pick))
        taken = taken | (kk[None, :] == pick[:, None])

    world = [orn_a.rotate(p) for p in slots_p]
    offset = Vec3(torch.stack([p.x for p in world], -1), torch.stack([p.y for p in world], -1),
                  torch.stack([p.z for p in world], -1))
    return Manifold(normal=orn_a.rotate(normal_local), offset_a=offset,
                    depth=torch.stack(slots_d, -1), feature=torch.stack(slots_f, -1),
                    contact_mask=torch.stack(slots_m, -1))
