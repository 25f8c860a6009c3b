"""Three- and four-body constraints: AreaConstraint, VolumeConstraint (reference
Constraints/AreaConstraint.cs, VolumeConstraint.cs) — cloth/softbody volume preservation.

Bank convention: these use the 4-body bank (body_c/body_d columns); AreaConstraint sets
body_d = body_a with dynamic_d = False.

Counterpart of ``bepuphysics2_tpu/constraints/joints/multibody.py``; each formula and its
operation order follow the JAX module one for one."""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ..contact import BodyVel
from .base import get_spring, safe_eff, spring_cols, zero3, zero_dv


class MultiBodyContext:
    """Gathered state for 4-body banks (A, B, C, D)."""

    def __init__(self, pos, vel, inv_mass, active):
        self.pos = pos  # list[Vec3] × 4
        self.vel = vel  # list[BodyVel] × 4
        self.inv_mass = inv_mass  # list × 4
        self.active = active


class AreaConstraint:
    """Maintains 2× the area of triangle ABC (reference Constraints/AreaConstraint.cs).
    prestep: target_scaled_area(1), spring(2). impulse: 1. Linear jacobians only."""

    name = "area"
    FIELDS = (("target_scaled_area", "scalar"), ("spring", "spring"))
    N_PRESTEP = 3
    N_IMPULSE = 1
    N_BODIES = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [d.target_scaled_area, *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _jacobians(ctx: MultiBodyContext):
        pa, pb, pc = ctx.pos[0], ctx.pos[1], ctx.pos[2]
        ab = pb - pa
        ac = pc - pa
        abxac = ab.cross(ac)
        normal_length = abxac.length()
        normal = abxac * torch.where(normal_length > 1e-10, 1.0 / normal_length.clamp_min(1e-10), 0.0)
        jac_b = ac.cross(normal)
        jac_c = normal.cross(ab)
        neg_jac_a = jac_b + jac_c
        ca = neg_jac_a.length_squared()
        cb = jac_b.length_squared()
        cc = jac_c.length_squared()
        j2 = torch.clamp_min(ca + cb + cc, 1e-14)
        inv_jlen = 1.0 / torch.sqrt(j2)
        return normal_length, neg_jac_a, jac_b, jac_c, ca, cb, cc, inv_jlen

    @staticmethod
    def _apply(ctx, neg_jac_a, jac_b, jac_c, scaled_csi):
        dv = [
            BodyVel(-1.0 * neg_jac_a * (scaled_csi * ctx.inv_mass[0]), zero3(scaled_csi)),
            BodyVel(jac_b * (scaled_csi * ctx.inv_mass[1]), zero3(scaled_csi)),
            BodyVel(jac_c * (scaled_csi * ctx.inv_mass[2]), zero3(scaled_csi)),
            zero_dv(scaled_csi.shape, device=scaled_csi.device),
        ]
        return dv

    @staticmethod
    def warm_start(p, imp, ctx: MultiBodyContext):
        _, nja, jb, jc, *_rest, inv_jlen = AreaConstraint._jacobians(ctx)
        return AreaConstraint._apply(ctx, nja, jb, jc, inv_jlen * imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: MultiBodyContext, dt, inv_dt):
        normal_length, nja, jb, jc, ca, cb, cc, inv_jlen = AreaConstraint._jacobians(ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 1), dt)
        inv_eff = torch.clamp_min(
            inv_jlen * inv_jlen * (ca * ctx.inv_mass[0] + cb * ctx.inv_mass[1]
                                   + cc * ctx.inv_mass[2]), 1e-14)
        eff = safe_eff(cfm, inv_eff)
        bias = (p[:, 0] - normal_length) * inv_jlen * err_to_vel
        csv = inv_jlen * (
            ctx.vel[1].linear.dot(jb) + ctx.vel[2].linear.dot(jc) - ctx.vel[0].linear.dot(nja)
        )
        csi = (bias - csv) * eff - imp[:, 0] * softness
        csi = torch.where(ctx.active, csi, 0.0)
        new_acc = imp[:, 0] + csi
        dv = AreaConstraint._apply(ctx, nja, jb, jc, inv_jlen * csi)
        return new_acc[:, None], dv


class VolumeConstraint:
    """Maintains 6× the volume of tetrahedron ABCD (reference
    Constraints/VolumeConstraint.cs). prestep: target_scaled_volume(1), spring(2).
    impulse: 1. Linear jacobians only."""

    name = "volume"
    FIELDS = (("target_scaled_volume", "scalar"), ("spring", "spring"))
    N_PRESTEP = 3
    N_IMPULSE = 1
    N_BODIES = 4

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [d.target_scaled_volume, *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _jacobians(ctx: MultiBodyContext):
        pa, pb, pc, pd = ctx.pos
        ab = pb - pa
        ac = pc - pa
        ad = pd - pa
        jac_b = ac.cross(ad)
        jac_c = ad.cross(ab)
        jac_d = ab.cross(ac)
        neg_jac_a = jac_b + jac_c + jac_d
        ca = neg_jac_a.length_squared()
        cb = jac_b.length_squared()
        cc = jac_c.length_squared()
        cd = jac_d.length_squared()
        j2 = torch.clamp_min(ca + cb + cc + cd, 1e-14)
        inv_jlen = 1.0 / torch.sqrt(j2)
        return ad, neg_jac_a, jac_b, jac_c, jac_d, ca, cb, cc, cd, inv_jlen

    @staticmethod
    def _apply(ctx, nja, jb, jc, jd, scaled_csi):
        return [
            BodyVel(-1.0 * nja * (scaled_csi * ctx.inv_mass[0]), zero3(scaled_csi)),
            BodyVel(jb * (scaled_csi * ctx.inv_mass[1]), zero3(scaled_csi)),
            BodyVel(jc * (scaled_csi * ctx.inv_mass[2]), zero3(scaled_csi)),
            BodyVel(jd * (scaled_csi * ctx.inv_mass[3]), zero3(scaled_csi)),
        ]

    @staticmethod
    def warm_start(p, imp, ctx: MultiBodyContext):
        _, nja, jb, jc, jd, *_rest, inv_jlen = VolumeConstraint._jacobians(ctx)
        return VolumeConstraint._apply(ctx, nja, jb, jc, jd, inv_jlen * imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: MultiBodyContext, dt, inv_dt):
        ad, nja, jb, jc, jd, ca, cb, cc, cd, inv_jlen = VolumeConstraint._jacobians(ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 1), dt)
        inv_eff = torch.clamp_min(
            inv_jlen * inv_jlen * (ca * ctx.inv_mass[0] + cb * ctx.inv_mass[1]
                                   + cc * ctx.inv_mass[2] + cd * ctx.inv_mass[3]), 1e-14)
        eff = safe_eff(cfm, inv_eff)
        volume = jd.dot(ad)
        bias = (p[:, 0] - volume) * inv_jlen * err_to_vel
        csv = inv_jlen * (
            ctx.vel[1].linear.dot(jb)
            + ctx.vel[2].linear.dot(jc)
            + ctx.vel[3].linear.dot(jd)
            - ctx.vel[0].linear.dot(nja)
        )
        csi = (bias - csv) * eff - imp[:, 0] * softness
        csi = torch.where(ctx.active, csi, 0.0)
        new_acc = imp[:, 0] + csi
        dv = VolumeConstraint._apply(ctx, nja, jb, jc, jd, inv_jlen * csi)
        return new_acc[:, None], dv
