"""Linear-axis joint family: PointOnLineServo, LinearAxisServo, LinearAxisMotor,
LinearAxisLimit (reference Constraints/PointOnLineServo.cs, LinearAxisServo.cs,
LinearAxisMotor.cs, LinearAxisLimit.cs).

Counterpart of ``bepuphysics2_tpu/constraints/joints/linear_axis.py``; each formula and
its operation order follow the JAX module one for one."""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Sym2, Vec2, build_orthonormal_basis
from ..contact import BodyVel
from .base import (
    JointContext,
    clamp_impulse_scalar,
    clamp_impulse_vec2,
    get3,
    get_motor,
    get_servo,
    get_spring,
    limit_solve_1dof,
    motor_cols,
    motor_softness,
    safe_eff,
    servo_clamped_bias_scalar,
    servo_cols,
    spring_cols,
)


class PointOnLineServo:
    """Constrains B's anchor to a line fixed on A — 2 DOF perpendicular to the line
    (reference Constraints/PointOnLineServo.cs). prestep: local_offset_a(3),
    local_offset_b(3), local_direction(3), spring(2), servo(3). impulse: 2."""

    name = "point_on_line_servo"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"),
              ("local_direction", "vec3"), ("spring", "spring"), ("servo", "servo"))
    N_PRESTEP = 14
    N_IMPULSE = 2

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b, *d.local_direction,
             *spring_cols(d.spring_frequency, d.spring_damping), *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def _jacobians(p, ctx: JointContext):
        """reference PointOnLineServo.ComputeJacobians."""
        local_dir = get3(p, 6)
        ltx, lty = build_orthonormal_basis(local_dir)
        anchor_a = ctx.orn_a.rotate(get3(p, 0))
        offset_b = ctx.orn_b.rotate(get3(p, 3))
        direction = ctx.orn_a.rotate(local_dir)
        ab = ctx.pos_b - ctx.pos_a
        anchor_b = offset_b + ab
        anchor_offset = anchor_b - anchor_a
        d_along = anchor_offset.dot(direction)
        offset_a = anchor_a + direction * d_along  # closest point on line to B's anchor
        t1 = ctx.orn_a.rotate(ltx)
        t2 = ctx.orn_a.rotate(lty)
        ang_a1 = offset_a.cross(t1)
        ang_a2 = offset_a.cross(t2)
        ang_b1 = t1.cross(offset_b)
        ang_b2 = t2.cross(offset_b)
        return anchor_offset, t1, t2, ang_a1, ang_a2, ang_b1, ang_b2

    @staticmethod
    def _apply(ctx, t1, t2, ang_a1, ang_a2, ang_b1, ang_b2, csi: Vec2):
        lin = t1 * csi.x + t2 * csi.y
        ang_a = ang_a1 * csi.x + ang_a2 * csi.y
        ang_b = ang_b1 * csi.x + ang_b2 * csi.y
        dva = BodyVel(lin * ctx.inertia_a.inv_mass, ctx.inertia_a.inv_inertia.transform(ang_a))
        dvb = BodyVel(
            -1.0 * lin * ctx.inertia_b.inv_mass, ctx.inertia_b.inv_inertia.transform(ang_b)
        )
        return dva, dvb

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, t1, t2, a1, a2, b1, b2 = PointOnLineServo._jacobians(p, ctx)
        return PointOnLineServo._apply(ctx, t1, t2, a1, a2, b1, b2, Vec2(imp[:, 0], imp[:, 1]))

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        anchor_offset, t1, t2, a1, a2, b1, b2 = PointOnLineServo._jacobians(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 9), dt)
        servo = get_servo(p, 11)

        imass = ctx.inertia_a.inv_mass + ctx.inertia_b.inv_mass
        ia = ctx.inertia_a.inv_inertia
        ib = ctx.inertia_b.inv_inertia
        m11 = imass + ia.vector_sandwich(a1) + ib.vector_sandwich(b1)
        m22 = imass + ia.vector_sandwich(a2) + ib.vector_sandwich(b2)
        m12 = ia.transform(a1).dot(a2) + ib.transform(b1).dot(b2)
        eff = Sym2(m11, m12, m22).inverse()

        error = Vec2(anchor_offset.dot(t1), anchor_offset.dot(t2))
        # servo clamped bias (2D, reference ServoSettingsWide 2D overload)
        err_len = torch.sqrt(error.x * error.x + error.y * error.y)
        axis = Vec2(
            torch.where(err_len > 1e-10, error.x / err_len.clamp_min(1e-10), 0.0),
            torch.where(err_len > 1e-10, error.y / err_len.clamp_min(1e-10), 0.0),
        )
        base_speed = torch.minimum(servo.base_speed, err_len * inv_dt)
        unclamped = err_len * err_to_vel
        target = torch.maximum(base_speed, unclamped)
        scale = torch.where(target < 1e-10, 1.0, torch.clamp_max(servo.maximum_speed / target.clamp_min(1e-10), 1.0))
        bias = Vec2(axis.x * scale * torch.maximum(unclamped, base_speed), axis.y * scale * torch.maximum(unclamped, base_speed))
        max_imp = servo.maximum_force * dt

        csv = Vec2(
            ctx.vel_a.linear.dot(t1) - ctx.vel_b.linear.dot(t1)
            + ctx.vel_a.angular.dot(a1) + ctx.vel_b.angular.dot(b1),
            ctx.vel_a.linear.dot(t2) - ctx.vel_b.linear.dot(t2)
            + ctx.vel_a.angular.dot(a2) + ctx.vel_b.angular.dot(b2),
        )
        raw = eff.transform(Vec2(bias.x - csv.x, bias.y - csv.y))
        acc = Vec2(imp[:, 0], imp[:, 1])
        csi = Vec2(raw.x * cfm - acc.x * softness, raw.y * cfm - acc.y * softness)
        new_acc, csi = clamp_impulse_vec2(max_imp, acc, csi)
        keep = ~ctx.active
        new_acc = Vec2(torch.where(keep, acc.x, new_acc.x), torch.where(keep, acc.y, new_acc.y))
        csi = Vec2(new_acc.x - acc.x, new_acc.y - acc.y)
        dva, dvb = PointOnLineServo._apply(ctx, t1, t2, a1, a2, b1, b2, csi)
        return torch.stack([new_acc.x, new_acc.y], -1), dva, dvb


def _linear_axis_jacobians(p, ctx: JointContext, off_a_col=0, off_b_col=3, normal_col=6):
    """reference LinearAxisServo.ComputeJacobians: plane normal on A; measures B's anchor
    offset along the normal."""
    normal = ctx.orn_a.rotate(get3(p, normal_col))
    anchor_a = ctx.orn_a.rotate(get3(p, off_a_col))
    offset_b = ctx.orn_b.rotate(get3(p, off_b_col))
    ab = ctx.pos_b - ctx.pos_a
    anchor_b = ab + offset_b
    plane_normal_dot = (anchor_b - anchor_a).dot(normal)
    offset_to_plane_point = anchor_b - normal * plane_normal_dot
    ang_a = offset_to_plane_point.cross(normal)
    ang_b = normal.cross(offset_b)
    return plane_normal_dot, normal, ang_a, ang_b


def _linear_axis_apply(ctx, normal, ang_a, ang_b, csi):
    lin = normal * csi
    dva = BodyVel(lin * ctx.inertia_a.inv_mass, ctx.inertia_a.inv_inertia.transform(ang_a * csi))
    dvb = BodyVel(
        -1.0 * lin * ctx.inertia_b.inv_mass, ctx.inertia_b.inv_inertia.transform(ang_b * csi)
    )
    return dva, dvb


def _linear_axis_eff_mass(ctx, ang_a, ang_b, cfm):
    inv_eff = (
        ctx.inertia_a.inv_mass
        + ctx.inertia_b.inv_mass
        + ctx.inertia_a.inv_inertia.vector_sandwich(ang_a)
        + ctx.inertia_b.inv_inertia.vector_sandwich(ang_b)
    )
    return safe_eff(cfm, inv_eff)


def _linear_axis_csv(ctx, normal, ang_a, ang_b):
    return (
        ctx.vel_a.linear.dot(normal)
        - ctx.vel_b.linear.dot(normal)
        + ctx.vel_a.angular.dot(ang_a)
        + ctx.vel_b.angular.dot(ang_b)
    )


class LinearAxisServo:
    """Servo driving B's anchor to a target offset along A's plane normal (reference
    Constraints/LinearAxisServo.cs). prestep: local_offset_a(3), local_offset_b(3),
    local_plane_normal(3), target_offset(1), spring(2), servo(3). impulse: 1."""

    name = "linear_axis_servo"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"),
              ("local_plane_normal", "vec3"), ("target_offset", "scalar"), ("spring", "spring"),
              ("servo", "servo"))
    N_PRESTEP = 15
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b, *d.local_plane_normal, d.target_offset,
             *spring_cols(d.spring_frequency, d.spring_damping), *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, normal, ang_a, ang_b = _linear_axis_jacobians(p, ctx)
        return _linear_axis_apply(ctx, normal, ang_a, ang_b, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        pnd, normal, ang_a, ang_b = _linear_axis_jacobians(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 10), dt)
        servo = get_servo(p, 12)
        eff = _linear_axis_eff_mass(ctx, ang_a, ang_b, cfm)
        bias, max_imp = servo_clamped_bias_scalar(pnd - p[:, 9], err_to_vel, servo, dt, inv_dt)
        csv = _linear_axis_csv(ctx, normal, ang_a, ang_b)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        new_acc, csi = clamp_impulse_scalar(max_imp, imp[:, 0], csi)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _linear_axis_apply(ctx, normal, ang_a, ang_b, csi)
        return new_acc[:, None], dva, dvb


class LinearAxisMotor:
    """Drives relative velocity along A's axis (reference Constraints/LinearAxisMotor.cs).
    prestep: local_offset_a(3), local_offset_b(3), local_axis(3), target_velocity(1),
    motor(2). impulse: 1."""

    name = "linear_axis_motor"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"), ("local_axis", "vec3"),
              ("target_velocity", "scalar"), ("motor", "motor"))
    N_PRESTEP = 12
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b, *d.local_axis, d.target_velocity,
             *motor_cols(d.motor)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, normal, ang_a, ang_b = _linear_axis_jacobians(p, ctx)
        return _linear_axis_apply(ctx, normal, ang_a, ang_b, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        _, normal, ang_a, ang_b = _linear_axis_jacobians(p, ctx)
        cfm, softness, max_imp = motor_softness(get_motor(p, 10), dt)
        eff = _linear_axis_eff_mass(ctx, ang_a, ang_b, cfm)
        bias = p[:, 9]
        csv = _linear_axis_csv(ctx, normal, ang_a, ang_b)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        new_acc, csi = clamp_impulse_scalar(max_imp, imp[:, 0], csi)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _linear_axis_apply(ctx, normal, ang_a, ang_b, csi)
        return new_acc[:, None], dva, dvb


class LinearAxisLimit:
    """Limits B's anchor offset along A's axis to [min, max] (reference
    Constraints/LinearAxisLimit.cs). prestep: local_offset_a(3), local_offset_b(3),
    local_axis(3), min(1), max(1), spring(2). impulse: 1."""

    name = "linear_axis_limit"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"), ("local_axis", "vec3"),
              ("minimum_offset", "scalar"), ("maximum_offset", "scalar"), ("spring", "spring"))
    N_PRESTEP = 13
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b, *d.local_axis, d.minimum_offset,
             d.maximum_offset, *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def _side(p, pnd):
        use_min = pnd - p[:, 9] < p[:, 10] - pnd
        e = torch.where(use_min, pnd - p[:, 9], p[:, 10] - pnd)
        # family csv = −d(pnd)/dt; min side d(e)/dt = d(pnd)/dt = −csv → s=−1; max: +1.
        s = torch.where(use_min, -1.0, 1.0)
        return e, s

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        pnd, normal, ang_a, ang_b = _linear_axis_jacobians(p, ctx)
        _, s = LinearAxisLimit._side(p, pnd)
        return _linear_axis_apply(ctx, normal, ang_a, ang_b, s * imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        pnd, normal, ang_a, ang_b = _linear_axis_jacobians(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 11), dt)
        eff = _linear_axis_eff_mass(ctx, ang_a, ang_b, cfm)
        e, s = LinearAxisLimit._side(p, pnd)
        csv = _linear_axis_csv(ctx, normal, ang_a, ang_b)
        new_acc, csi = limit_solve_1dof(
            e, s * csv, eff, softness, imp[:, 0], inv_dt, err_to_vel, ctx.active
        )
        dva, dvb = _linear_axis_apply(ctx, normal, ang_a, ang_b, s * csi)
        return new_acc[:, None], dva, dvb
