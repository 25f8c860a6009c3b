"""One-body servo/motor constraints (reference Constraints/OneBodyLinearServo.cs,
OneBodyLinearMotor.cs, OneBodyAngularServo.cs, OneBodyAngularMotor.cs).

Counterpart of ``bepuphysics2_tpu/constraints/joints/onebody.py``; each formula and its
operation order follow the JAX module one for one.

Bank convention: body_b == body_a with dynamic_b = False; solve functions ignore the B
context and return a zero B delta."""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Sym3, Vec3
from ..contact import BodyVel
from .angular import _axis_angle
from .base import (
    JointContext,
    clamp_impulse_vec3,
    get3,
    get_motor,
    get_quat,
    get_servo,
    get_spring,
    motor_cols,
    motor_softness,
    servo_clamped_bias_vec3,
    servo_cols,
    spring_cols,
    zero3,
    zero_dv,
)


def _one_body_point_apply(ctx: JointContext, offset: Vec3, csi: Vec3):
    dva = BodyVel(csi * ctx.inertia_a.inv_mass, ctx.inertia_a.inv_inertia.transform(offset.cross(csi)))
    return dva, zero_dv(csi.x.shape, device=csi.x.device)


class OneBodyLinearServo:
    """Servo pulling a body point toward a world target (reference
    Constraints/OneBodyLinearServo.cs). prestep: local_offset(3), target(3), spring(2),
    servo(3). impulse: 3."""

    name = "one_body_linear_servo"
    FIELDS = (("local_offset", "vec3"), ("target", "vec3"), ("spring", "spring"),
              ("servo", "servo"))
    N_PRESTEP = 11
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset, *d.target, *spring_cols(d.spring_frequency, d.spring_damping),
             *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset = ctx.orn_a.rotate(get3(p, 0))
        return _one_body_point_apply(ctx, offset, Vec3(imp[:, 0], imp[:, 1], imp[:, 2]))

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset = ctx.orn_a.rotate(get3(p, 0))
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 6), dt)
        servo = get_servo(p, 8)
        grab = ctx.pos_a + offset
        error = get3(p, 3) - grab
        bias, max_imp = servo_clamped_bias_vec3(error, err_to_vel, servo, dt, inv_dt)
        csv = bias - ctx.vel_a.angular.cross(offset) - ctx.vel_a.linear
        inv_eff = ctx.inertia_a.inv_inertia.skew_sandwich(offset)
        m = ctx.inertia_a.inv_mass
        inv_eff = Sym3(inv_eff.xx + m, inv_eff.yx, inv_eff.yy + m, inv_eff.zx, inv_eff.zy, inv_eff.zz + m)
        eff = inv_eff.inverse()
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        csi = eff.transform(csv) * cfm - acc * softness
        new_acc, csi = clamp_impulse_vec3(max_imp, acc, csi)
        new_acc = new_acc.where(ctx.active, acc)
        csi = (new_acc - acc).where(ctx.active, zero3(ctx.active))
        dva, dvb = _one_body_point_apply(ctx, offset, csi)
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


class OneBodyLinearMotor:
    """Drives the velocity of a body point toward a target (reference
    Constraints/OneBodyLinearMotor.cs). prestep: local_offset(3), target_velocity(3),
    motor(2). impulse: 3."""

    name = "one_body_linear_motor"
    FIELDS = (("local_offset", "vec3"), ("target_velocity", "vec3"), ("motor", "motor"))
    N_PRESTEP = 8
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array([*d.local_offset, *d.target_velocity, *motor_cols(d.motor)], np.float32)

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset = ctx.orn_a.rotate(get3(p, 0))
        return _one_body_point_apply(ctx, offset, Vec3(imp[:, 0], imp[:, 1], imp[:, 2]))

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset = ctx.orn_a.rotate(get3(p, 0))
        cfm, softness, max_imp = motor_softness(get_motor(p, 6), dt)
        csv = get3(p, 3) - ctx.vel_a.angular.cross(offset) - ctx.vel_a.linear
        inv_eff = ctx.inertia_a.inv_inertia.skew_sandwich(offset)
        m = ctx.inertia_a.inv_mass
        inv_eff = Sym3(inv_eff.xx + m, inv_eff.yx, inv_eff.yy + m, inv_eff.zx, inv_eff.zy, inv_eff.zz + m)
        eff = inv_eff.inverse()
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        csi = eff.transform(csv) * cfm - acc * softness
        new_acc, csi = clamp_impulse_vec3(max_imp, acc, csi)
        new_acc = new_acc.where(ctx.active, acc)
        csi = (new_acc - acc).where(ctx.active, zero3(ctx.active))
        dva, dvb = _one_body_point_apply(ctx, offset, csi)
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


class OneBodyAngularServo:
    """Servo driving a body's orientation to a target (reference
    Constraints/OneBodyAngularServo.cs). prestep: target_orientation(4), spring(2),
    servo(3). impulse: 3."""

    name = "one_body_angular_servo"
    FIELDS = (("target_orientation", "quat"), ("spring", "spring"), ("servo", "servo"))
    N_PRESTEP = 9
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.target_orientation, *spring_cols(d.spring_frequency, d.spring_damping),
             *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        dva = BodyVel(zero3(acc.x), ctx.inertia_a.inv_inertia.transform(acc))
        return dva, zero_dv(acc.x.shape, device=acc.x.device)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 4), dt)
        servo = get_servo(p, 6)
        target = get_quat(p, 0)
        error_rot = target.mul(ctx.orn_a.conjugate())  # rotation from current to target
        axis, angle = _axis_angle(error_rot)
        base_speed = torch.minimum(servo.base_speed, angle * inv_dt)
        unclamped = angle * err_to_vel
        t_speed = torch.maximum(base_speed, unclamped)
        scale = torch.where(t_speed < 1e-10, 1.0, torch.clamp_max(servo.maximum_speed / t_speed.clamp_min(1e-10), 1.0))
        bias = axis * (scale * torch.maximum(unclamped, base_speed))
        max_imp = servo.maximum_force * dt
        eff = ctx.inertia_a.inv_inertia.inverse()
        csv = bias - ctx.vel_a.angular
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        csi = eff.transform(csv) * cfm - acc * softness
        new_acc, csi = clamp_impulse_vec3(max_imp, acc, csi)
        new_acc = new_acc.where(ctx.active, acc)
        csi = (new_acc - acc).where(ctx.active, zero3(ctx.active))
        dva = BodyVel(zero3(csi.x), ctx.inertia_a.inv_inertia.transform(csi))
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, zero_dv(csi.x.shape, device=csi.x.device)


class OneBodyAngularMotor:
    """Drives a body's angular velocity toward a target (reference
    Constraints/OneBodyAngularMotor.cs). prestep: target_velocity(3), motor(2). impulse: 3."""

    name = "one_body_angular_motor"
    FIELDS = (("target_velocity", "vec3"), ("motor", "motor"))
    N_PRESTEP = 5
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array([*d.target_velocity, *motor_cols(d.motor)], np.float32)

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        dva = BodyVel(zero3(acc.x), ctx.inertia_a.inv_inertia.transform(acc))
        return dva, zero_dv(acc.x.shape, device=acc.x.device)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        cfm, softness, max_imp = motor_softness(get_motor(p, 3), dt)
        eff = ctx.inertia_a.inv_inertia.inverse()
        csv = get3(p, 0) - ctx.vel_a.angular
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        csi = eff.transform(csv) * cfm - acc * softness
        new_acc, csi = clamp_impulse_vec3(max_imp, acc, csi)
        new_acc = new_acc.where(ctx.active, acc)
        csi = (new_acc - acc).where(ctx.active, zero3(ctx.active))
        dva = BodyVel(zero3(csi.x), ctx.inertia_a.inv_inertia.transform(csi))
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, zero_dv(csi.x.shape, device=csi.x.device)
