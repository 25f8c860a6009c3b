"""Speculative (velocity-expanded) world AABBs for every body: spheres, capsules, boxes,
cylinders, triangles (an offset box), and hulls, custom shapes and compounds (their
bounding sphere).

Counterpart of ``bepuphysics2_tpu/shapes/bounds.py`` (reference PoseIntegrator.cs:424
PredictBoundingBoxes + BoundingBoxHelpers.ExpandBoundingBoxes): one masked pass over all
bodies; the shape type selects the extent formula. ``present_types`` (the registry's
types, known on the host) leaves out the formulas of types the scene does not hold.
"""
from __future__ import annotations

import math

import torch

from ..utils.vec import Vec3
from .registry import BOX, CAPSULE, CYLINDER, SPHERE, TRIANGLE, ShapeData


def compute_shape_bounds(shape_type, params, max_radius, orn, present_types=None):
    """Local AABB half-extents for each body: (extent: Vec3, center_offset: Vec3).
    Hulls, custom shapes and compounds read their bounding sphere."""
    has = lambda t: present_types is None or t in present_types
    m = orn.to_matrix()
    zero = torch.zeros_like(params[:, 0])
    r = params[:, 0]
    sphere_ext = Vec3(r, r, r)
    # Capsule: segment along local Y, endpoints ±half_length · ry, plus the radius.
    hl = params[:, 1]
    seg = Vec3(m.ry.x.abs(), m.ry.y.abs(), m.ry.z.abs()) * hl
    capsule_ext = Vec3(seg.x + r, seg.y + r, seg.z + r)
    hx, hy, hz = params[:, 0], params[:, 1], params[:, 2]
    box_ext = Vec3(
        m.rx.x.abs() * hx + m.ry.x.abs() * hy + m.rz.x.abs() * hz,
        m.rx.y.abs() * hx + m.ry.y.abs() * hy + m.rz.y.abs() * hz,
        m.rx.z.abs() * hx + m.ry.z.abs() * hy + m.rz.z.abs() * hz,
    )
    ext = Vec3(max_radius, max_radius, max_radius)
    ext = box_ext.where(shape_type == BOX, ext)
    ext = sphere_ext.where(shape_type == SPHERE, ext)
    ext = capsule_ext.where(shape_type == CAPSULE, ext)
    center = Vec3(zero, zero, zero)
    if has(CYLINDER):
        # Half length along |ry| plus the disc's radius along sqrt(1 - ry_i^2) per axis.
        disc = Vec3(*(torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0)) for c in m.ry))
        cyl_ext = Vec3(m.ry.x.abs() * hl + disc.x * r, m.ry.y.abs() * hl + disc.y * r,
                       m.ry.z.abs() * hl + disc.z * r)
        ext = cyl_ext.where(shape_type == CYLINDER, ext)
    if has(TRIANGLE):
        # Min and max over the three rotated vertices: an offset box, not a centred one.
        va = orn.rotate(Vec3(params[:, 0], params[:, 1], params[:, 2]))
        vb = orn.rotate(Vec3(params[:, 3], params[:, 4], params[:, 5]))
        vc = orn.rotate(Vec3(params[:, 6], params[:, 7], params[:, 8]))
        tri_min = va.min(vb).min(vc)
        tri_max = va.max(vb).max(vc)
        tri = shape_type == TRIANGLE
        ext = ((tri_max - tri_min) * 0.5).where(tri, ext)
        center = ((tri_min + tri_max) * 0.5).where(tri, center)
    return ext, center


def compute_body_bounds(pos, orn, vel, omega, shape_id, shapes: ShapeData, dt,
                        spec_min=None, present_types=None):
    """Speculative world AABBs (aabb_min, aabb_max) of shape (N,).

    ``spec_min``: per-body minimum speculative margin; each AABB grows by half of it."""
    shape_id_c = shape_id.clamp_min(0).long()
    stype = torch.where(shape_id >= 0, shapes.type[shape_id_c], -1)
    params = shapes.params[shape_id_c]
    max_radius = shapes.max_radius[shape_id_c]

    ext, center = compute_shape_bounds(stype, params, max_radius, orn, present_types)
    lo = pos + center - ext
    hi = pos + center + ext

    # Angular worst case |w|·dt·r (clamped to π·r); spheres are rotation-invariant, and
    # no rotation carries a shape outside pos ± max_radius.
    ang = torch.where(
        stype == SPHERE, 0.0, torch.clamp_max(omega.length() * dt, math.pi) * max_radius
    )
    ang_v = Vec3(ang, ang, ang)
    r_v = Vec3(max_radius, max_radius, max_radius)
    lo = (lo - ang_v).max(pos - r_v)
    hi = (hi + ang_v).min(pos + r_v)

    disp = vel * dt
    zeros = Vec3.zeros(disp.x.shape, device=disp.x.device)
    lo = lo + disp.min(zeros)
    hi = hi + disp.max(zeros)

    if spec_min is not None:
        mh = 0.5 * spec_min
        mv = Vec3(mh, mh, mh)
        lo = lo - mv
        hi = hi + mv
    return lo, hi
