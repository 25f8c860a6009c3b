"""Combined-DOF joints: Weld (6-DOF), Hinge (5-DOF), SwivelHinge (4-DOF).

Counterpart of ``bepuphysics2_tpu/constraints/joints/combo.py``; each formula and its
operation order follow the JAX module one for one.

These solve their coupled DOF blocks simultaneously like the reference (Weld's 6x6 LDLT,
Hinge's Symmetric5x5 inverse — reference Constraints/Weld.cs, Hinge.cs, SwivelHinge.cs),
implemented here with Schur-complement block solves over Sym3/Sym2 types."""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Sym2, Sym3, Vec2, Vec3, build_orthonormal_basis
from ..contact import BodyVel
from .angular import _axis_angle
from .base import JointContext, get3, get_quat, get_spring, spring_cols, zero3


class Weld:
    """Locks relative pose: B's center at A-local offset, B's orientation at A-local
    orientation (reference Constraints/Weld.cs). prestep: local_offset(3),
    local_orientation(4), spring(2). impulse: 6 (orientation 3 + offset 3)."""

    name = "weld"
    FIELDS = (("local_offset", "vec3"), ("local_orientation", "quat"), ("spring", "spring"))
    N_PRESTEP = 9
    N_IMPULSE = 6

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset, *d.local_orientation,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _apply(ctx: JointContext, offset: Vec3, orientation_csi: Vec3, offset_csi: Vec3):
        """reference Weld.ApplyImpulse: A angular receives offset×offsetCSI + orientationCSI;
        B angular receives −orientationCSI; linear ±offsetCSI."""
        dva = BodyVel(
            offset_csi * ctx.inertia_a.inv_mass,
            ctx.inertia_a.inv_inertia.transform(offset.cross(offset_csi) + orientation_csi),
        )
        dvb = BodyVel(
            -1.0 * offset_csi * ctx.inertia_b.inv_mass,
            -1.0 * ctx.inertia_b.inv_inertia.transform(orientation_csi),
        )
        return dva, dvb

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset = ctx.orn_a.rotate(get3(p, 0))
        o_csi = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        f_csi = Vec3(imp[:, 3], imp[:, 4], imp[:, 5])
        return Weld._apply(ctx, offset, o_csi, f_csi)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset = ctx.orn_a.rotate(get3(p, 0))
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 7), dt)

        ia = ctx.inertia_a.inv_inertia
        ib = ctx.inertia_b.inv_inertia
        # 6x6 inverse effective mass blocks (reference Weld.Solve):
        #   A = Ia⁻¹ + Ib⁻¹                      (orientation rows)
        #   B = Ia⁻¹ · skew(offset)ᵀ coupling    (orientation × offset)
        #   D = skew(offset)·Ia⁻¹·skew(offset)ᵀ + (1/ma + 1/mb)·I
        A = ia + ib
        D = ia.skew_sandwich(offset)
        lin = ctx.inertia_a.inv_mass + ctx.inertia_b.inv_mass
        D = Sym3(D.xx + lin, D.yx, D.yy + lin, D.zx, D.zy, D.zz + lin)
        # Coupling B[i][j] = (orientation row i)·Ia⁻¹·(offset angular row j)
        # orientation rows = e_i (A side; B side −e_i has no offset coupling);
        # offset angular rows on A = e_j × offset (from wA×offset term).
        # B[i][j] = e_i · Ia⁻¹ (e_j × offset) — a full 3x3 (not symmetric).
        u = [
            Vec3(torch.zeros_like(offset.x), -offset.z, offset.y),  # e_x × offset... e_x×r=(0,-rz,ry)
            Vec3(offset.z, torch.zeros_like(offset.x), -offset.x),
            Vec3(-offset.y, offset.x, torch.zeros_like(offset.x)),
        ]
        # Coupling B[i][j] = e_i·Ia⁻¹·(offset×e_j) = −e_i·Ia⁻¹(e_j×offset): note negation
        # (the offset rows' angular-A jacobian is offset×e_j, not e_j×offset).
        iu = [-1.0 * ia.transform(ui) for ui in u]
        # B as rows b_i·: B[i][j] = (iu[j])_i
        # position error & rotation error
        pos_error = (ctx.pos_b - ctx.pos_a) - offset
        target_orn_b = ctx.orn_a.mul(get_quat(p, 3))
        rot_err_q = ctx.orn_b.mul(target_orn_b.conjugate())
        rot_axis, rot_angle = _axis_angle(rot_err_q)

        orientation_bias = rot_axis * (rot_angle * err_to_vel)
        offset_bias = pos_error * err_to_vel

        # csv (bias − measured): orientation rows measure wA − wB; offset rows measure
        # vA + wA×offset − vB.
        o_csv = orientation_bias - (ctx.vel_a.angular - ctx.vel_b.angular)
        f_csv = offset_bias - (
            ctx.vel_a.linear + ctx.vel_a.angular.cross(offset) - ctx.vel_b.linear
        )

        # Solve [[A, B],[Bᵀ, D]] [o; f] = [o_csv; f_csv] via Schur on A.
        A_inv = A.inverse()
        # B f means Σ_j f_j · Ia⁻¹(e_j×offset) → vector Σ f_j iu[j]
        def B_mul(v: Vec3) -> Vec3:
            return Vec3(
                iu[0].x * v.x + iu[1].x * v.y + iu[2].x * v.z,
                iu[0].y * v.x + iu[1].y * v.y + iu[2].y * v.z,
                iu[0].z * v.x + iu[1].z * v.y + iu[2].z * v.z,
            )

        def BT_mul(v: Vec3) -> Vec3:
            return Vec3(iu[0].dot(v), iu[1].dot(v), iu[2].dot(v))

        # Schur complement S = D − Bᵀ A⁻¹ B (3x3 symmetric).
        ai_b = [A_inv.transform(iu[j]) for j in range(3)]
        S = Sym3(
            D.xx - iu[0].dot(ai_b[0]),
            D.yx - iu[1].dot(ai_b[0]),
            D.yy - iu[1].dot(ai_b[1]),
            D.zx - iu[2].dot(ai_b[0]),
            D.zy - iu[2].dot(ai_b[1]),
            D.zz - iu[2].dot(ai_b[2]),
        )
        S_inv = S.inverse()
        rhs_f = f_csv - BT_mul(A_inv.transform(o_csv))
        f_csi = S_inv.transform(rhs_f)
        o_csi = A_inv.transform(o_csv - B_mul(f_csi))

        o_acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        f_acc = Vec3(imp[:, 3], imp[:, 4], imp[:, 5])
        o_csi = o_csi * cfm - o_acc * softness
        f_csi = f_csi * cfm - f_acc * softness
        o_csi = o_csi.where(ctx.active, zero3(ctx.active))
        f_csi = f_csi.where(ctx.active, zero3(ctx.active))
        new_o = o_acc + o_csi
        new_f = f_acc + f_csi
        dva, dvb = Weld._apply(ctx, offset, o_csi, f_csi)
        return (
            torch.stack([new_o.x, new_o.y, new_o.z, new_f.x, new_f.y, new_f.z], -1),
            dva,
            dvb,
        )


def _hinge_jacobians(p, ctx: JointContext, axis_a_col, axis_b_col):
    local_axis_a = get3(p, axis_a_col)
    lx, ly = build_orthonormal_basis(local_axis_a)
    axis_a = ctx.orn_a.rotate(local_axis_a)
    jx = ctx.orn_a.rotate(lx)
    jy = ctx.orn_a.rotate(ly)
    axis_b = ctx.orn_b.rotate(get3(p, axis_b_col))
    return axis_a, axis_b, jx, jy


class Hinge:
    """Ball socket + angular hinge solved as one coupled 5-DOF constraint (reference
    Constraints/Hinge.cs, Symmetric5x5 effective mass). prestep: local_offset_a(3),
    local_hinge_axis_a(3), local_offset_b(3), local_hinge_axis_b(3), spring(2).
    impulse: 5 (ball socket 3 + hinge 2)."""

    name = "hinge"
    FIELDS = (("local_offset_a", "vec3"), ("local_hinge_axis_a", "vec3"),
              ("local_offset_b", "vec3"), ("local_hinge_axis_b", "vec3"), ("spring", "spring"))
    N_PRESTEP = 14
    N_IMPULSE = 5

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_hinge_axis_a, *d.local_offset_b, *d.local_hinge_axis_b,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _apply(ctx, offset_a, offset_b, jx, jy, bs_csi: Vec3, h_csi: Vec2):
        ang_imp = jx * h_csi.x + jy * h_csi.y
        dva = BodyVel(
            bs_csi * ctx.inertia_a.inv_mass,
            ctx.inertia_a.inv_inertia.transform(offset_a.cross(bs_csi) + ang_imp),
        )
        dvb = BodyVel(
            -1.0 * bs_csi * ctx.inertia_b.inv_mass,
            ctx.inertia_b.inv_inertia.transform(bs_csi.cross(offset_b) - ang_imp),
        )
        return dva, dvb

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset_a = ctx.orn_a.rotate(get3(p, 0))
        offset_b = ctx.orn_b.rotate(get3(p, 6))
        _, _, jx, jy = _hinge_jacobians(p, ctx, 3, 9)
        bs = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        h = Vec2(imp[:, 3], imp[:, 4])
        return Hinge._apply(ctx, offset_a, offset_b, jx, jy, bs, h)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a = ctx.orn_a.rotate(get3(p, 0))
        offset_b = ctx.orn_b.rotate(get3(p, 6))
        axis_a, axis_b, jx, jy = _hinge_jacobians(p, ctx, 3, 9)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 12), dt)

        ia = ctx.inertia_a.inv_inertia
        ib = ctx.inertia_b.inv_inertia
        # Block A: ball socket inverse effective mass (3x3).
        A = ia.skew_sandwich(offset_a) + ib.skew_sandwich(offset_b)
        lin = ctx.inertia_a.inv_mass + ctx.inertia_b.inv_mass
        A = Sym3(A.xx + lin, A.yx, A.yy + lin, A.zx, A.zy, A.zz + lin)
        # Block D: angular hinge 2x2.
        d11 = ia.vector_sandwich(jx) + ib.vector_sandwich(jx)
        d22 = ia.vector_sandwich(jy) + ib.vector_sandwich(jy)
        d12 = ia.transform(jx).dot(jy) + ib.transform(jx).dot(jy)
        D = Sym2(d11, d12, d22)
        # Coupling B (3x2): B[i][c] = (e_i×ra)·Ia⁻¹·j_c + (e_i×rb)·Ib⁻¹·j_c
        ia_jx = ia.transform(jx)
        ia_jy = ia.transform(jy)
        ib_jx = ib.transform(jx)
        ib_jy = ib.transform(jy)
        ua = [
            Vec3(torch.zeros_like(offset_a.x), -offset_a.z, offset_a.y),
            Vec3(offset_a.z, torch.zeros_like(offset_a.x), -offset_a.x),
            Vec3(-offset_a.y, offset_a.x, torch.zeros_like(offset_a.x)),
        ]
        ub = [
            Vec3(torch.zeros_like(offset_b.x), -offset_b.z, offset_b.y),
            Vec3(offset_b.z, torch.zeros_like(offset_b.x), -offset_b.x),
            Vec3(-offset_b.y, offset_b.x, torch.zeros_like(offset_b.x)),
        ]
        # Coupling sign: ball-socket angular rows are rA×e_i = −(e_i×rA) on A and
        # +(e_i×rB) on B; hinge rows are +j on A, −j on B ⇒
        # B[i][c] = −(uaᵢ·Ia⁻¹jc + ubᵢ·Ib⁻¹jc).
        Bx = Vec3(*(-(ua[i].dot(ia_jx) + ub[i].dot(ib_jx)) for i in range(3)))  # column for jx
        By = Vec3(*(-(ua[i].dot(ia_jy) + ub[i].dot(ib_jy)) for i in range(3)))  # column for jy

        # Errors.
        bs_error = (ctx.pos_b - ctx.pos_a) + offset_b - offset_a
        bx_dot = axis_b.dot(jx)
        by_dot = axis_b.dot(jy)
        on_x = axis_b - jx * bx_dot
        on_y = axis_b - jy * by_dot
        lxn = on_x.length()
        lyn = on_y.length()
        on_x = (on_x * torch.where(lxn > 1e-7, 1.0 / lxn.clamp_min(1e-7), 0.0)).where(lxn > 1e-7, axis_a)
        on_y = (on_y * torch.where(lyn > 1e-7, 1.0 / lyn.clamp_min(1e-7), 0.0)).where(lyn > 1e-7, axis_a)
        ex = torch.acos(torch.clamp(on_x.dot(axis_a), -1.0, 1.0))
        ey = torch.acos(torch.clamp(on_y.dot(axis_a), -1.0, 1.0))
        ex = torch.where(on_x.dot(jy) < 0.0, ex, -ex)
        ey = torch.where(on_y.dot(jx) < 0.0, -ey, ey)

        bs_bias = bs_error * err_to_vel
        h_bias = Vec2(-ex * err_to_vel, -ey * err_to_vel)

        bs_csv = bs_bias - (
            ctx.vel_a.linear + ctx.vel_a.angular.cross(offset_a)
            - ctx.vel_b.linear - ctx.vel_b.angular.cross(offset_b)
        )
        wdiff = ctx.vel_a.angular - ctx.vel_b.angular
        h_csv = Vec2(h_bias.x - wdiff.dot(jx), h_bias.y - wdiff.dot(jy))

        # Schur on A: S = D − Bᵀ A⁻¹ B (2x2).
        A_inv = A.inverse()
        ai_bx = A_inv.transform(Bx)
        ai_by = A_inv.transform(By)
        S = Sym2(d11 - Bx.dot(ai_bx), d12 - By.dot(ai_bx), d22 - By.dot(ai_by))
        S_inv = S.inverse()
        rhs_h = Vec2(h_csv.x - Bx.dot(A_inv.transform(bs_csv)), h_csv.y - By.dot(A_inv.transform(bs_csv)))
        h_csi = S_inv.transform(rhs_h)
        bs_csi = A_inv.transform(bs_csv - Vec3(
            Bx.x * h_csi.x + By.x * h_csi.y,
            Bx.y * h_csi.x + By.y * h_csi.y,
            Bx.z * h_csi.x + By.z * h_csi.y,
        ))

        bs_acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        h_acc = Vec2(imp[:, 3], imp[:, 4])
        bs_csi = bs_csi * cfm - bs_acc * softness
        h_csi = Vec2(h_csi.x * cfm - h_acc.x * softness, h_csi.y * cfm - h_acc.y * softness)
        bs_csi = bs_csi.where(ctx.active, zero3(ctx.active))
        h_csi = Vec2(torch.where(ctx.active, h_csi.x, 0.0), torch.where(ctx.active, h_csi.y, 0.0))
        new_bs = bs_acc + bs_csi
        new_h = Vec2(h_acc.x + h_csi.x, h_acc.y + h_csi.y)
        dva, dvb = Hinge._apply(ctx, offset_a, offset_b, jx, jy, bs_csi, h_csi)
        return (
            torch.stack([new_bs.x, new_bs.y, new_bs.z, new_h.x, new_h.y], -1),
            dva,
            dvb,
        )


class SwivelHinge:
    """Ball socket + perpendicular swivel/hinge axes — 4 DOF removed (reference
    Constraints/SwivelHinge.cs). Solved as coupled ball socket (3) + 1 angular DOF.
    prestep: local_offset_a(3), local_swivel_axis_a(3), local_offset_b(3),
    local_hinge_axis_b(3), spring(2). impulse: 4."""

    name = "swivel_hinge"
    FIELDS = (("local_offset_a", "vec3"), ("local_swivel_axis_a", "vec3"),
              ("local_offset_b", "vec3"), ("local_hinge_axis_b", "vec3"), ("spring", "spring"))
    N_PRESTEP = 14
    N_IMPULSE = 4

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_swivel_axis_a, *d.local_offset_b, *d.local_hinge_axis_b,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _jacobian(p, ctx):
        swivel_a = ctx.orn_a.rotate(get3(p, 3))
        hinge_b = ctx.orn_b.rotate(get3(p, 9))
        jac = swivel_a.cross(hinge_b)
        ok = jac.length_squared() > 1e-7
        t1, _ = build_orthonormal_basis(swivel_a)
        return swivel_a, hinge_b, jac.where(ok, t1)

    @staticmethod
    def _apply(ctx, offset_a, offset_b, jac, bs_csi: Vec3, s_csi):
        ang_imp = jac * s_csi
        dva = BodyVel(
            bs_csi * ctx.inertia_a.inv_mass,
            ctx.inertia_a.inv_inertia.transform(offset_a.cross(bs_csi) + ang_imp),
        )
        dvb = BodyVel(
            -1.0 * bs_csi * ctx.inertia_b.inv_mass,
            ctx.inertia_b.inv_inertia.transform(bs_csi.cross(offset_b) - ang_imp),
        )
        return dva, dvb

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset_a = ctx.orn_a.rotate(get3(p, 0))
        offset_b = ctx.orn_b.rotate(get3(p, 6))
        _, _, jac = SwivelHinge._jacobian(p, ctx)
        return SwivelHinge._apply(
            ctx, offset_a, offset_b, jac, Vec3(imp[:, 0], imp[:, 1], imp[:, 2]), imp[:, 3]
        )

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a = ctx.orn_a.rotate(get3(p, 0))
        offset_b = ctx.orn_b.rotate(get3(p, 6))
        swivel_a, hinge_b, jac = SwivelHinge._jacobian(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 12), dt)

        ia = ctx.inertia_a.inv_inertia
        ib = ctx.inertia_b.inv_inertia
        A = ia.skew_sandwich(offset_a) + ib.skew_sandwich(offset_b)
        lin = ctx.inertia_a.inv_mass + ctx.inertia_b.inv_mass
        A = Sym3(A.xx + lin, A.yx, A.yy + lin, A.zx, A.zy, A.zz + lin)
        d_scalar = ia.vector_sandwich(jac) + ib.vector_sandwich(jac)
        ia_j = ia.transform(jac)
        ib_j = ib.transform(jac)
        ua = [
            Vec3(torch.zeros_like(offset_a.x), -offset_a.z, offset_a.y),
            Vec3(offset_a.z, torch.zeros_like(offset_a.x), -offset_a.x),
            Vec3(-offset_a.y, offset_a.x, torch.zeros_like(offset_a.x)),
        ]
        ub = [
            Vec3(torch.zeros_like(offset_b.x), -offset_b.z, offset_b.y),
            Vec3(offset_b.z, torch.zeros_like(offset_b.x), -offset_b.x),
            Vec3(-offset_b.y, offset_b.x, torch.zeros_like(offset_b.x)),
        ]
        # Coupling sign: see Hinge — the ball-socket angular rows flip the sign.
        Bcol = Vec3(*(-(ua[i].dot(ia_j) + ub[i].dot(ib_j)) for i in range(3)))

        bs_error = (ctx.pos_b - ctx.pos_a) + offset_b - offset_a
        s_error = swivel_a.dot(hinge_b)
        bs_csv = bs_error * err_to_vel - (
            ctx.vel_a.linear + ctx.vel_a.angular.cross(offset_a)
            - ctx.vel_b.linear - ctx.vel_b.angular.cross(offset_b)
        )
        s_csv = -s_error * err_to_vel - (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)

        A_inv = A.inverse()
        ai_b = A_inv.transform(Bcol)
        S = d_scalar - Bcol.dot(ai_b)
        s_csi = (s_csv - Bcol.dot(A_inv.transform(bs_csv))) / S
        bs_csi = A_inv.transform(bs_csv - Bcol * s_csi)

        bs_acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        s_acc = imp[:, 3]
        bs_csi = bs_csi * cfm - bs_acc * softness
        s_csi = s_csi * cfm - s_acc * softness
        bs_csi = bs_csi.where(ctx.active, zero3(ctx.active))
        s_csi = torch.where(ctx.active, s_csi, 0.0)
        new_bs = bs_acc + bs_csi
        new_s = s_acc + s_csi
        dva, dvb = SwivelHinge._apply(ctx, offset_a, offset_b, jac, bs_csi, s_csi)
        return torch.stack([new_bs.x, new_bs.y, new_bs.z, new_s], -1), dva, dvb
