"""Angular joint family: AngularHinge, AngularSwivelHinge, SwingLimit, TwistServo,
TwistLimit, TwistMotor, AngularServo, AngularMotor, AngularAxisMotor,
AngularAxisGearMotor.

Counterpart of ``bepuphysics2_tpu/constraints/joints/angular.py`` (reference
Constraints/*.cs, cited per type); each formula and its operation order follow the JAX
module one for one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Quat, Sym2, Vec2, Vec3, build_orthonormal_basis
from ..contact import BodyVel
from .base import (
    JointContext,
    apply_angular_impulse,
    clamp_impulse_scalar,
    clamp_impulse_vec3,
    full3,
    get3,
    get_motor,
    get_quat,
    get_servo,
    get_spring,
    limit_solve_1dof,
    motor_cols,
    motor_softness,
    safe_eff,
    servo_clamped_bias_scalar,
    servo_cols,
    spring_cols,
    zero3,
)


def _angular_1dof_apply(ctx: JointContext, jac: Vec3, csi):
    """Equal-and-opposite angular impulse csi along jacobian jac."""
    imp = jac * csi
    dva = BodyVel(zero3(csi), ctx.inertia_a.inv_inertia.transform(imp))
    dvb = BodyVel(zero3(csi), -1.0 * ctx.inertia_b.inv_inertia.transform(imp))
    return dva, dvb


def _angular_1dof_effective_mass(ctx: JointContext, jac: Vec3):
    return (
        ctx.inertia_a.inv_inertia.vector_sandwich(jac)
        + ctx.inertia_b.inv_inertia.vector_sandwich(jac)
    )


def _quat_between(v1: Vec3, v2: Vec3) -> Quat:
    """Shortest-arc rotation q with q.rotate(v1) == v2 for unit vectors (reference
    QuaternionWide.GetQuaternionBetweenNormalizedVectors)."""
    d = v1.dot(v2)
    c = v1.cross(v2)
    w = 1.0 + d
    q = Quat(c.x, c.y, c.z, w)
    # Antiparallel fallback: rotate about any perpendicular axis by pi.
    perp = Vec3(-v1.y, v1.x, torch.zeros_like(v1.x))
    perp_ok = perp.length_squared() > 1e-10
    perp = perp.where(perp_ok, Vec3(torch.zeros_like(v1.x), -v1.z, v1.y))
    anti = d < -0.999999
    q = Quat(
        torch.where(anti, perp.x, q.x),
        torch.where(anti, perp.y, q.y),
        torch.where(anti, perp.z, q.z),
        torch.where(anti, 0.0, q.w),
    )
    return q.normalize()


def _axis_angle(q: Quat):
    """(axis, angle) from quaternion with sign canonicalization (reference
    QuaternionWide.GetAxisAngleFromQuaternion)."""
    neg = q.w < 0.0
    ax = Vec3(torch.where(neg, -q.x, q.x), torch.where(neg, -q.y, q.y), torch.where(neg, -q.z, q.z))
    qw = torch.where(neg, -q.w, q.w)
    ln = ax.length()
    axis = ax * torch.where(ln > 1e-14, 1.0 / ln.clamp_min(1e-14), 0.0)
    axis = axis.where(ln > 1e-14, full3(ln, 1.0, 0.0, 0.0))
    angle = 2.0 * torch.acos(torch.clamp(qw, -1.0, 1.0))
    return axis, angle


def signed_angle_difference(a, b):
    """Wrapped b − a into (−π, π] (reference MathHelper.GetSignedAngleDifference)."""
    two_pi = 2.0 * math.pi
    x = (b - a) * (1.0 / two_pi) + 0.5
    return (x - torch.floor(x) - 0.5) * two_pi


class AngularHinge:
    """Constrains the hinge axes of A and B to stay aligned — 2 angular DOFs removed
    (reference Constraints/AngularHinge.cs). prestep: local_hinge_axis_a(3),
    local_hinge_axis_b(3), spring(2). impulse: 2."""

    name = "angular_hinge"
    FIELDS = (("local_hinge_axis_a", "vec3"), ("local_hinge_axis_b", "vec3"), ("spring", "spring"))
    N_PRESTEP = 8
    N_IMPULSE = 2

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_hinge_axis_a, *d.local_hinge_axis_b,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _jacobians(p, ctx: JointContext):
        local_axis_a = get3(p, 0)
        # Build constraint tangent basis in A local space, then rotate (consistency trick
        # per reference AngularHinge.ComputeJacobians).
        lx, ly = build_orthonormal_basis(local_axis_a)
        axis_a = ctx.orn_a.rotate(local_axis_a)
        jx = ctx.orn_a.rotate(lx)
        jy = ctx.orn_a.rotate(ly)
        return axis_a, jx, jy

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, jx, jy = AngularHinge._jacobians(p, ctx)
        world_imp = jx * imp[:, 0] + jy * imp[:, 1]
        return apply_angular_impulse(world_imp, ctx.inertia_a, ctx.inertia_b)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        axis_a, jx, jy = AngularHinge._jacobians(p, ctx)
        axis_b = ctx.orn_b.rotate(get3(p, 3))
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 6), dt)

        # Effective mass of the 2x3 angular jacobian [jx; jy].
        ia = ctx.inertia_a.inv_inertia
        ib = ctx.inertia_b.inv_inertia
        m11 = ia.vector_sandwich(jx) + ib.vector_sandwich(jx)
        m22 = ia.vector_sandwich(jy) + ib.vector_sandwich(jy)
        m12 = ia.transform(jx).dot(jy) + ib.transform(jx).dot(jy)
        eff = Sym2(m11, m12, m22).inverse()

        # Error angles via projection onto tangent planes (reference GetErrorAngles).
        bx_dot = axis_b.dot(jx)
        by_dot = axis_b.dot(jy)
        on_plane_x = axis_b - jx * bx_dot
        on_plane_y = axis_b - jy * by_dot
        lx = on_plane_x.length()
        ly = on_plane_y.length()
        on_plane_x = (on_plane_x * torch.where(lx > 1e-7, 1.0 / lx.clamp_min(1e-7), 0.0)).where(
            lx > 1e-7, axis_a
        )
        on_plane_y = (on_plane_y * torch.where(ly > 1e-7, 1.0 / ly.clamp_min(1e-7), 0.0)).where(
            ly > 1e-7, axis_a
        )
        ex = torch.acos(torch.clamp(on_plane_x.dot(axis_a), -1.0, 1.0))
        ey = torch.acos(torch.clamp(on_plane_y.dot(axis_a), -1.0, 1.0))
        ex = torch.where(on_plane_x.dot(jy) < 0.0, ex, -ex)
        ey = torch.where(on_plane_y.dot(jx) < 0.0, -ey, ey)

        bias = Vec2(-ex * err_to_vel, -ey * err_to_vel)
        bias_imp = eff.transform(bias)

        diff = ctx.vel_a.angular - ctx.vel_b.angular
        csv = Vec2(diff.dot(jx), diff.dot(jy))
        csi_v = eff.transform(csv)
        csi = Vec2(
            bias_imp.x - csi_v.x * cfm - imp[:, 0] * softness,
            bias_imp.y - csi_v.y * cfm - imp[:, 1] * softness,
        )
        csi = Vec2(torch.where(ctx.active, csi.x, 0.0), torch.where(ctx.active, csi.y, 0.0))
        new_imp = torch.stack([imp[:, 0] + csi.x, imp[:, 1] + csi.y], -1)
        world_imp = jx * csi.x + jy * csi.y
        dva, dvb = apply_angular_impulse(world_imp, ctx.inertia_a, ctx.inertia_b)
        return new_imp, dva, dvb


class AngularSwivelHinge:
    """Keeps A's swivel axis perpendicular to B's hinge axis — 1 angular DOF (reference
    Constraints/AngularSwivelHinge.cs). prestep: local_swivel_axis_a(3),
    local_hinge_axis_b(3), spring(2). impulse: 1."""

    name = "angular_swivel_hinge"
    FIELDS = (("local_swivel_axis_a", "vec3"), ("local_hinge_axis_b", "vec3"), ("spring", "spring"))
    N_PRESTEP = 8
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_swivel_axis_a, *d.local_hinge_axis_b,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _jacobian(p, ctx: JointContext):
        swivel_a = ctx.orn_a.rotate(get3(p, 0))
        hinge_b = ctx.orn_b.rotate(get3(p, 3))
        jac = swivel_a.cross(hinge_b)
        ok = jac.length_squared() > 1e-7
        t1, _ = build_orthonormal_basis(swivel_a)
        return swivel_a, hinge_b, jac.where(ok, t1)

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, _, jac = AngularSwivelHinge._jacobian(p, ctx)
        return _angular_1dof_apply(ctx, jac, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        swivel_a, hinge_b, jac = AngularSwivelHinge._jacobian(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 6), dt)
        eff = safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        # C = dot(swivelA, hingeB) = 0
        error = swivel_a.dot(hinge_b)
        bias = -error * err_to_vel
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        csi = torch.where(ctx.active, csi, 0.0)
        new_imp = imp[:, 0] + csi
        dva, dvb = _angular_1dof_apply(ctx, jac, csi)
        return new_imp[:, None], dva, dvb


class SwingLimit:
    """Limits the angle between two body axes: dot(axisA, axisB) >= minimum_dot
    (reference Constraints/SwingLimit.cs). prestep: axis_local_a(3), axis_local_b(3),
    minimum_dot(1), spring(2). impulse: 1 (nonnegative)."""

    name = "swing_limit"
    FIELDS = (("axis_local_a", "vec3"), ("axis_local_b", "vec3"), ("minimum_dot", "scalar"),
              ("spring", "spring"))
    N_PRESTEP = 9
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        min_dot = float(np.cos(d.maximum_swing_angle)) if hasattr(d, "maximum_swing_angle") else d.minimum_dot
        return np.array(
            [*d.axis_local_a, *d.axis_local_b, min_dot,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _jacobian(p, ctx: JointContext):
        axis_a = ctx.orn_a.rotate(get3(p, 0))
        axis_b = ctx.orn_b.rotate(get3(p, 3))
        jac = axis_a.cross(axis_b)
        ok = jac.length_squared() > 1e-7
        t1, _ = build_orthonormal_basis(axis_a)
        return axis_a, axis_b, jac.where(ok, t1)

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, _, jac = SwingLimit._jacobian(p, ctx)
        return _angular_1dof_apply(ctx, jac, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        axis_a, axis_b, jac = SwingLimit._jacobian(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 7), dt)
        eff = safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        error = axis_a.dot(axis_b) - p[:, 6]
        bias = -torch.minimum(error * inv_dt, error * err_to_vel)
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        new_acc = torch.clamp_min(imp[:, 0] + csi, 0.0)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _angular_1dof_apply(ctx, jac, csi)
        return new_acc[:, None], dva, dvb


def _twist_jacobian(p, ctx: JointContext, basis_a_col, basis_b_col):
    """Shared twist measurement (reference TwistServo.ComputeJacobian/ComputeCurrentAngle):
    local basis quaternions rotate so that Z = twist axis, X = angle reference."""
    basis_q_a = ctx.orn_a.mul(get_quat(p, basis_a_col))  # apply local basis then orientation
    basis_q_b = ctx.orn_b.mul(get_quat(p, basis_b_col))
    a_x = basis_q_a.rotate(full3(p[:, 0], 1.0, 0.0, 0.0))
    a_y = basis_q_a.rotate(full3(p[:, 0], 0.0, 1.0, 0.0))
    a_z = basis_q_a.rotate(full3(p[:, 0], 0.0, 0.0, 1.0))
    b_x = basis_q_b.rotate(full3(p[:, 0], 1.0, 0.0, 0.0))
    b_z = basis_q_b.rotate(full3(p[:, 0], 0.0, 0.0, 1.0))
    jac = a_z + b_z
    ln = jac.length()
    jac = (jac * torch.where(ln > 1e-10, 1.0 / ln.clamp_min(1e-10), 0.0)).where(ln > 1e-10, a_z)
    # Current twist angle: align B's Z onto A's Z, measure aligned B.X against A's X/Y.
    aligning = _quat_between(b_z, a_z)
    aligned_bx = aligning.rotate(b_x)
    x = aligned_bx.dot(a_x)
    y = aligned_bx.dot(a_y)
    angle = torch.acos(torch.clamp(x, -1.0, 1.0))
    angle = torch.where(y < 0.0, -angle, angle)
    return jac, angle


class TwistServo:
    """Servo driving the twist angle around the shared basis Z (reference
    Constraints/TwistServo.cs). prestep: local_basis_a(4 quat), local_basis_b(4),
    target_angle(1), spring(2), servo(3). impulse: 1."""

    name = "twist_servo"
    FIELDS = (("local_basis_a", "quat"), ("local_basis_b", "quat"), ("target_angle", "scalar"),
              ("spring", "spring"), ("servo", "servo"))
    N_PRESTEP = 14
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_basis_a, *d.local_basis_b, d.target_angle,
             *spring_cols(d.spring_frequency, d.spring_damping), *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        jac, _ = _twist_jacobian(p, ctx, 0, 4)
        return _angular_1dof_apply(ctx, jac, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        jac, angle = _twist_jacobian(p, ctx, 0, 4)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 9), dt)
        servo = get_servo(p, 11)
        eff = safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        error = signed_angle_difference(p[:, 8], angle)
        bias, max_imp = servo_clamped_bias_scalar(error, err_to_vel, servo, dt, inv_dt)
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        csi = bias * eff - imp[:, 0] * softness - csv * eff
        new_acc, csi = clamp_impulse_scalar(max_imp, imp[:, 0], csi)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _angular_1dof_apply(ctx, jac, csi)
        return new_acc[:, None], dva, dvb


class TwistLimit:
    """Twist angle constrained to [min, max] (reference Constraints/TwistLimit.cs).
    prestep: local_basis_a(4), local_basis_b(4), min(1), max(1), spring(2). impulse: 1."""

    name = "twist_limit"
    FIELDS = (("local_basis_a", "quat"), ("local_basis_b", "quat"), ("minimum_angle", "scalar"),
              ("maximum_angle", "scalar"), ("spring", "spring"))
    N_PRESTEP = 12
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_basis_a, *d.local_basis_b, d.minimum_angle, d.maximum_angle,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _side(p, angle):
        err_min = signed_angle_difference(p[:, 8], angle)  # >0 when above min
        err_max = signed_angle_difference(angle, p[:, 9])  # >0 when below max
        use_min = err_min < err_max
        e = torch.where(use_min, err_min, err_max)
        # csv_measured = (wA−wB)·jac = −d(angle)/dt; d(e)/dt = ±d(angle)/dt.
        s = torch.where(use_min, -1.0, 1.0)
        return e, s

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        jac, angle = _twist_jacobian(p, ctx, 0, 4)
        _, s = TwistLimit._side(p, angle)
        return _angular_1dof_apply(ctx, jac, s * imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        jac, angle = _twist_jacobian(p, ctx, 0, 4)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 10), dt)
        eff = safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        e, s = TwistLimit._side(p, angle)
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        new_acc, csi = limit_solve_1dof(
            e, s * csv, eff, softness, imp[:, 0], inv_dt, err_to_vel, ctx.active
        )
        dva, dvb = _angular_1dof_apply(ctx, jac, s * csi)
        return new_acc[:, None], dva, dvb


class TwistMotor:
    """Drives relative twist velocity about the shared axis (reference
    Constraints/TwistMotor.cs). prestep: local_axis_a(3), local_axis_b(3),
    target_velocity(1), motor(2). impulse: 1."""

    name = "twist_motor"
    FIELDS = (("local_axis_a", "vec3"), ("local_axis_b", "vec3"), ("target_velocity", "scalar"),
              ("motor", "motor"))
    N_PRESTEP = 9
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_axis_a, *d.local_axis_b, d.target_velocity, *motor_cols(d.motor)],
            np.float32,
        )

    @staticmethod
    def _jacobian(p, ctx: JointContext):
        axis_a = ctx.orn_a.rotate(get3(p, 0))
        axis_b = ctx.orn_b.rotate(get3(p, 3))
        jac = axis_a + axis_b
        ln = jac.length()
        return (jac * torch.where(ln > 1e-10, 1.0 / ln.clamp_min(1e-10), 0.0)).where(
            ln > 1e-10, axis_a
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        jac = TwistMotor._jacobian(p, ctx)
        return _angular_1dof_apply(ctx, jac, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        jac = TwistMotor._jacobian(p, ctx)
        cfm, softness, max_imp = motor_softness(get_motor(p, 7), dt)
        eff = safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        bias = p[:, 6]
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        new_acc, csi = clamp_impulse_scalar(max_imp, imp[:, 0], csi)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _angular_1dof_apply(ctx, jac, csi)
        return new_acc[:, None], dva, dvb


class AngularServo:
    """Drives the relative orientation to a target (3-DOF servo, reference
    Constraints/AngularServo.cs). prestep: target_relative_rotation_local_a(4 quat),
    spring(2), servo(3). impulse: 3."""

    name = "angular_servo"
    FIELDS = (("target_relative_rotation", "quat"), ("spring", "spring"), ("servo", "servo"))
    N_PRESTEP = 9
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.target_relative_rotation,
             *spring_cols(d.spring_frequency, d.spring_damping), *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        return apply_angular_impulse(acc, ctx.inertia_a, ctx.inertia_b)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        target_rel = get_quat(p, 0)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 4), dt)
        servo = get_servo(p, 6)
        # targetOrientationB = Concatenate(targetRel, orientationA) = orientationA∘targetRel
        target_orn_b = ctx.orn_a.mul(target_rel)
        error_rotation = ctx.orn_b.mul(target_orn_b.conjugate())
        # (Concatenate(inverseTarget, orientationB) = orientationB∘target⁻¹)
        err_axis, err_len = _axis_angle(error_rotation)

        inv_eff = ctx.inertia_a.inv_inertia + ctx.inertia_b.inv_inertia
        eff = inv_eff.inverse()

        base_speed = torch.minimum(servo.base_speed, err_len * inv_dt)
        unclamped = err_len * err_to_vel
        target_speed = torch.maximum(base_speed, unclamped)
        scale = torch.where(
            target_speed < 1e-10, 1.0, torch.clamp_max(servo.maximum_speed / target_speed.clamp_min(1e-10), 1.0)
        )
        bias = err_axis * (scale * torch.maximum(unclamped, base_speed))
        max_imp = servo.maximum_force * dt

        csv = bias - (ctx.vel_a.angular - ctx.vel_b.angular)
        csi = eff.transform(csv) * cfm
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        csi = csi - acc * softness
        new_acc, csi = clamp_impulse_vec3(max_imp, acc, csi)
        new_acc = new_acc.where(ctx.active, acc)
        csi = (new_acc - acc).where(ctx.active, zero3(ctx.active))
        dva, dvb = apply_angular_impulse(csi, ctx.inertia_a, ctx.inertia_b)
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


class AngularMotor:
    """Drives relative angular velocity toward a target in A's local frame (reference
    Constraints/AngularMotor.cs). prestep: target_velocity_local_a(3), motor(2). impulse: 3."""

    name = "angular_motor"
    FIELDS = (("target_velocity", "vec3"), ("motor", "motor"))
    N_PRESTEP = 5
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array([*d.target_velocity, *motor_cols(d.motor)], np.float32)

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        return apply_angular_impulse(acc, ctx.inertia_a, ctx.inertia_b)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        cfm, softness, max_imp = motor_softness(get_motor(p, 3), dt)
        inv_eff = ctx.inertia_a.inv_inertia + ctx.inertia_b.inv_inertia
        eff = inv_eff.inverse()
        bias = ctx.orn_a.rotate(get3(p, 0))
        csv = bias - (ctx.vel_a.angular - ctx.vel_b.angular)
        csi = eff.transform(csv) * cfm
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        csi = csi - acc * softness
        new_acc, csi = clamp_impulse_vec3(max_imp, acc, csi)
        new_acc = new_acc.where(ctx.active, acc)
        csi = (new_acc - acc).where(ctx.active, zero3(ctx.active))
        dva, dvb = apply_angular_impulse(csi, ctx.inertia_a, ctx.inertia_b)
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


class AngularAxisMotor:
    """Drives angular velocity around an axis attached to A (reference
    Constraints/AngularAxisMotor.cs). prestep: local_axis_a(3), target_velocity(1),
    motor(2). impulse: 1."""

    name = "angular_axis_motor"
    FIELDS = (("local_axis_a", "vec3"), ("target_velocity", "scalar"), ("motor", "motor"))
    N_PRESTEP = 6
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array([*d.local_axis_a, d.target_velocity, *motor_cols(d.motor)], np.float32)

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        jac = ctx.orn_a.rotate(get3(p, 0))
        return _angular_1dof_apply(ctx, jac, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        jac = ctx.orn_a.rotate(get3(p, 0))
        cfm, softness, max_imp = motor_softness(get_motor(p, 4), dt)
        eff = safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        bias = p[:, 3]
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        new_acc, csi = clamp_impulse_scalar(max_imp, imp[:, 0], csi)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _angular_1dof_apply(ctx, jac, csi)
        return new_acc[:, None], dva, dvb


class AngularAxisGearMotor:
    """Constrains wB·axis = ratio · wA·axis (reference
    Constraints/AngularAxisGearMotor.cs). prestep: local_axis_a(3), velocity_scale(1),
    motor(2). impulse: 1."""

    name = "angular_axis_gear_motor"
    FIELDS = (("local_axis_a", "vec3"), ("velocity_scale", "scalar"), ("motor", "motor"))
    N_PRESTEP = 6
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array([*d.local_axis_a, d.velocity_scale, *motor_cols(d.motor)], np.float32)

    @staticmethod
    def _apply(ctx, axis, scale, csi):
        # jacobian A = axis·scale, jacobian B = −axis
        imp_a = axis * (csi * scale)
        imp_b = axis * csi
        dva = BodyVel(zero3(csi), ctx.inertia_a.inv_inertia.transform(imp_a))
        dvb = BodyVel(zero3(csi), -1.0 * ctx.inertia_b.inv_inertia.transform(imp_b))
        return dva, dvb

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        axis = ctx.orn_a.rotate(get3(p, 0))
        return AngularAxisGearMotor._apply(ctx, axis, p[:, 3], imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        axis = ctx.orn_a.rotate(get3(p, 0))
        scale = p[:, 3]
        cfm, softness, max_imp = motor_softness(get_motor(p, 4), dt)
        inv_eff = (
            ctx.inertia_a.inv_inertia.vector_sandwich(axis) * scale * scale
            + ctx.inertia_b.inv_inertia.vector_sandwich(axis)
        )
        eff = safe_eff(cfm, inv_eff)
        csv = ctx.vel_a.angular.dot(axis) * scale - ctx.vel_b.angular.dot(axis)
        csi = eff * (-csv) - imp[:, 0] * softness
        new_acc, csi = clamp_impulse_scalar(max_imp, imp[:, 0], csi)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = AngularAxisGearMotor._apply(ctx, axis, scale, csi)
        return new_acc[:, None], dva, dvb
