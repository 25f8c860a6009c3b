"""Convex contact manifold constraint: one masked kernel for all of Contact1-4{,OneBody}.

Counterpart of ``bepuphysics2_tpu/constraints/contact.py`` (reference
Constraints/Contact/PenetrationLimit.cs, TangentFriction.cs, TwistFriction.cs,
ContactConvexTypes.cs:124-196). Each record is a row; the 4-contact dimension is a
trailing axis. Solve order: penetration, then tangent friction, then twist.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.spring import SpringSettings, compute_springiness
from ..utils.vec import Sym2, Sym3, Vec2, Vec3, build_orthonormal_basis


class ContactPrestep(NamedTuple):
    """Per-record prestep data (reference Contact{N}PrestepData)."""

    body_a: torch.Tensor  # (MP,) int32 body slot
    body_b: torch.Tensor  # (MP,) int32 body slot
    normal: Vec3  # (MP,) unit, from B to A
    offset_a: Vec3  # (MP, 4) contact offset from A's center (world)
    offset_b: Vec3  # (MP,) posB - posA
    depth: torch.Tensor  # (MP, 4) penetration depth (negative = speculative)
    contact_mask: torch.Tensor  # (MP, 4) bool
    valid: torch.Tensor  # (MP,) bool
    friction: torch.Tensor  # (MP,)
    spring: SpringSettings  # (MP,)
    max_recovery_velocity: torch.Tensor  # (MP,)
    feature: torch.Tensor  # (MP, 4) int32


class ContactImpulses(NamedTuple):
    """Accumulated impulses (reference Contact{N}AccumulatedImpulses)."""

    penetration: torch.Tensor  # (MP, 4)
    tangent: Vec2  # (MP,)
    twist: torch.Tensor  # (MP,)

    @staticmethod
    def zeros(capacity: int, device=None) -> "ContactImpulses":
        return ContactImpulses(
            torch.zeros((capacity, 4), dtype=torch.float32, device=device),
            Vec2.zeros(capacity, device=device),
            torch.zeros(capacity, dtype=torch.float32, device=device),
        )


class BodyVel(NamedTuple):
    linear: Vec3
    angular: Vec3


class GatheredInertia(NamedTuple):
    inv_mass: torch.Tensor
    inv_inertia: Sym3  # world-frame


def _friction_center(offset_a: Vec3, depth, contact_mask):
    """Depth-weighted manifold center: active (depth ≥ 0) contacts weigh 1, speculative
    weigh 0; fallback = mean of live contacts."""
    live = contact_mask.float()
    w = torch.where(depth < 0.0, 0.0, 1.0) * live
    wsum = w.sum(dim=-1)
    fallback = wsum == 0.0
    live_count = live.sum(dim=-1).clamp_min(1.0)
    w = torch.where(fallback[:, None], live / live_count[:, None],
                    w / wsum.clamp_min(1.0)[:, None])
    return Vec3((offset_a.x * w).sum(-1), (offset_a.y * w).sum(-1), (offset_a.z * w).sum(-1))


def _apply_pair_impulse(lin_impulse_a: Vec3, ang_impulse_a: Vec3, ang_impulse_b: Vec3,
                        ia: GatheredInertia, ib: GatheredInertia, va: BodyVel, vb: BodyVel):
    """Apply a world-space impulse (linear on A, its negative on B)."""
    new_va = BodyVel(va.linear + lin_impulse_a * ia.inv_mass,
                     va.angular + ia.inv_inertia.transform(ang_impulse_a))
    new_vb = BodyVel(vb.linear - lin_impulse_a * ib.inv_mass,
                     vb.angular + ib.inv_inertia.transform(ang_impulse_b))
    return new_va, new_vb


def warm_start(prestep: ContactPrestep, imp: ContactImpulses, ia: GatheredInertia,
               ib: GatheredInertia, va: BodyVel, vb: BodyVel):
    """Apply accumulated impulses to gathered velocities (Contact{N}Functions.WarmStart)."""
    n = prestep.normal
    t1, t2 = build_orthonormal_basis(n)
    center_a = _friction_center(prestep.offset_a, prestep.depth, prestep.contact_mask)
    center_b = center_a - prestep.offset_b

    tangent_w = t1 * imp.tangent.x + t2 * imp.tangent.y
    lin = tangent_w
    ang_a = center_a.cross(tangent_w)
    ang_b = tangent_w.cross(center_b)

    pen = imp.penetration * prestep.contact_mask
    lin = lin + n * pen.sum(dim=-1)
    off = prestep.offset_a
    n4 = Vec3(n.x[:, None], n.y[:, None], n.z[:, None])
    ang_a_pen = off.cross(n4)
    ang_a = ang_a + Vec3((ang_a_pen.x * pen).sum(-1), (ang_a_pen.y * pen).sum(-1),
                         (ang_a_pen.z * pen).sum(-1))
    off_b = Vec3(off.x - prestep.offset_b.x[:, None], off.y - prestep.offset_b.y[:, None],
                 off.z - prestep.offset_b.z[:, None])
    ang_b_pen = n4.cross(off_b)
    ang_b = ang_b + Vec3((ang_b_pen.x * pen).sum(-1), (ang_b_pen.y * pen).sum(-1),
                         (ang_b_pen.z * pen).sum(-1))

    ang_a = ang_a + n * imp.twist
    ang_b = ang_b - n * imp.twist
    return _apply_pair_impulse(lin, ang_a, ang_b, ia, ib, va, vb)


def solve(prestep: ContactPrestep, imp: ContactImpulses, ia: GatheredInertia,
          ib: GatheredInertia, va: BodyVel, vb: BodyVel, dt, inv_dt):
    """One velocity iteration for all records (masked). Returns (imp', va', vb')."""
    n = prestep.normal
    err_to_vel, cfm_scale, softness = compute_springiness(prestep.spring, dt)

    # ---- Penetration: 4 sequential per-contact solves (shared bodies; reference order).
    pen = imp.penetration.clone()
    for k in range(4):
        off_k = Vec3(prestep.offset_a.x[:, k], prestep.offset_a.y[:, k], prestep.offset_a.z[:, k])
        off_bk = off_k - prestep.offset_b
        ang_a = off_k.cross(n)
        ang_b = n.cross(off_bk)
        inv_eff = (ia.inv_mass + ib.inv_mass + ia.inv_inertia.vector_sandwich(ang_a)
                   + ib.inv_inertia.vector_sandwich(ang_b))
        effective_mass = torch.where(inv_eff > 0.0, cfm_scale / inv_eff.clamp_min(1e-30), 0.0)
        depth_k = prestep.depth[:, k]
        bias = torch.minimum(
            depth_k * inv_dt, torch.minimum(depth_k * err_to_vel, prestep.max_recovery_velocity)
        )
        csv = (va.linear.dot(n) - vb.linear.dot(n) + va.angular.dot(ang_a)
               + vb.angular.dot(ang_b))
        acc_k = pen[:, k]
        negated_csi = acc_k * softness + (csv - bias) * effective_mass
        new_acc = torch.clamp_min(acc_k - negated_csi, 0.0)
        live = prestep.contact_mask[:, k] & prestep.valid
        new_acc = torch.where(live, new_acc, acc_k)
        corrective = torch.where(live, new_acc - acc_k, 0.0)
        pen[:, k] = new_acc
        va, vb = _apply_pair_impulse(n * corrective, ang_a * corrective, ang_b * corrective,
                                     ia, ib, va, vb)

    # ---- Tangent friction (2-DOF block at the manifold center).
    t1, t2 = build_orthonormal_basis(n)
    center_a = _friction_center(prestep.offset_a, prestep.depth, prestep.contact_mask)
    center_b = center_a - prestep.offset_b
    ang_a1 = center_a.cross(t1)
    ang_a2 = center_a.cross(t2)
    ang_b1 = t1.cross(center_b)
    ang_b2 = t2.cross(center_b)
    imass = ia.inv_mass + ib.inv_mass
    m11 = imass + ia.inv_inertia.vector_sandwich(ang_a1) + ib.inv_inertia.vector_sandwich(ang_b1)
    m22 = imass + ia.inv_inertia.vector_sandwich(ang_a2) + ib.inv_inertia.vector_sandwich(ang_b2)
    m12 = (ia.inv_inertia.transform(ang_a1).dot(ang_a2)
           + ib.inv_inertia.transform(ang_b1).dot(ang_b2))
    eff = Sym2(m11, m12, m22).inverse()
    csv1 = vb.linear.dot(t1) - va.linear.dot(t1) - va.angular.dot(ang_a1) - vb.angular.dot(ang_b1)
    csv2 = vb.linear.dot(t2) - va.linear.dot(t2) - va.angular.dot(ang_a2) - vb.angular.dot(ang_b2)
    csi = eff.transform(Vec2(csv1, csv2))

    contact_count = prestep.contact_mask.float().sum(-1).clamp_min(1.0)
    premul_friction = prestep.friction / contact_count
    pen_masked = pen * prestep.contact_mask
    max_tangent = premul_friction * pen_masked.sum(-1)

    prev_t = imp.tangent
    new_t = Vec2(prev_t.x + csi.x, prev_t.y + csi.y)
    mag = new_t.length()
    scale = torch.clamp_max(max_tangent / mag.clamp_min(1e-16), 1.0)
    new_t = new_t * scale
    rec_live = prestep.valid
    new_t = Vec2(torch.where(rec_live, new_t.x, prev_t.x), torch.where(rec_live, new_t.y, prev_t.y))
    corr_t = Vec2(new_t.x - prev_t.x, new_t.y - prev_t.y)
    tangent_w = t1 * corr_t.x + t2 * corr_t.y
    va, vb = _apply_pair_impulse(tangent_w, center_a.cross(tangent_w),
                                 tangent_w.cross(center_b), ia, ib, va, vb)

    # ---- Twist friction: lever = Σ pen_i · |offset_i − center| (depth lever for one contact).
    dist = Vec3(
        prestep.offset_a.x - center_a.x[:, None],
        prestep.offset_a.y - center_a.y[:, None],
        prestep.offset_a.z - center_a.z[:, None],
    ).length()
    single = contact_count <= 1.0
    lever0 = prestep.depth[:, 0].clamp_min(0.0)
    twist_cap = torch.where(
        single,
        premul_friction * pen_masked[:, 0] * lever0,
        premul_friction * (pen_masked * dist).sum(-1),
    )
    inv_eff_tw = ia.inv_inertia.vector_sandwich(n) + ib.inv_inertia.vector_sandwich(n)
    eff_tw = torch.where(inv_eff_tw == 0.0, 0.0, 1.0 / inv_eff_tw.clamp_min(1e-30))
    csv_tw = va.angular.dot(n) - vb.angular.dot(n)
    csi_tw = -csv_tw * eff_tw
    prev_tw = imp.twist
    new_tw = torch.clamp(prev_tw + csi_tw, min=-twist_cap, max=twist_cap)
    new_tw = torch.where(rec_live, new_tw, prev_tw)
    corr_tw = new_tw - prev_tw
    va, vb = _apply_pair_impulse(Vec3.zeros(corr_tw.shape, device=corr_tw.device),
                                 n * corr_tw, -(n * corr_tw), ia, ib, va, vb)
    return ContactImpulses(pen, new_t, new_tw), va, vb


def incremental_depth_update(prestep: ContactPrestep, va: BodyVel, vb: BodyVel, dt) -> ContactPrestep:
    """Per-substep depth update from relative contact velocity
    (reference PenetrationLimit.UpdatePenetrationDepth)."""
    off = prestep.offset_a
    c = lambda t: t[:, None]
    wa = Vec3(c(va.angular.x), c(va.angular.y), c(va.angular.z))
    la = Vec3(c(va.linear.x), c(va.linear.y), c(va.linear.z))
    contact_vel_a = wa.cross(off) + la
    off_b = Vec3(off.x - c(prestep.offset_b.x), off.y - c(prestep.offset_b.y),
                 off.z - c(prestep.offset_b.z))
    wb = Vec3(c(vb.angular.x), c(vb.angular.y), c(vb.angular.z))
    lb = Vec3(c(vb.linear.x), c(vb.linear.y), c(vb.linear.z))
    contact_vel_b = wb.cross(off_b) + lb
    dv = contact_vel_a - contact_vel_b
    n4 = Vec3(c(prestep.normal.x), c(prestep.normal.y), c(prestep.normal.z))
    return prestep._replace(depth=prestep.depth - n4.dot(dv) * dt)
