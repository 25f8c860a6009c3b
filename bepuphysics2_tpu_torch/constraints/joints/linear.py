"""Linear joint family: BallSocket, BallSocketServo, BallSocketMotor, CenterDistance,
CenterDistanceLimit, DistanceServo, DistanceLimit.

Counterpart of ``bepuphysics2_tpu/constraints/joints/linear.py`` (reference
Constraints/BallSocket.cs:66 and the files cited per type). A joint class is a namespace
of static functions over SoA columns (see ``base``); each formula and its operation order
follow the JAX module one for one.
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Vec3
from ..contact import BodyVel
from .base import (
    JointContext,
    apply_linear_offset_impulse,
    ball_socket_effective_mass,
    ball_socket_solve_iteration,
    full3,
    get3,
    get_motor,
    get_servo,
    get_spring,
    limit_solve_1dof,
    motor_cols,
    motor_softness,
    safe_eff,
    servo_clamped_bias_scalar,
    servo_clamped_bias_vec3,
    servo_cols,
    spring_cols,
    zero3,
)


class BallSocket:
    """Constrains a point on A to a point on B (reference Constraints/BallSocket.cs:66).
    prestep: local_offset_a(3), local_offset_b(3), spring(2). impulse: 3."""

    name = "ball_socket"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"), ("spring", "spring"))
    N_PRESTEP = 8
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array([*d.local_offset_a, *d.local_offset_b,
                         *spring_cols(d.spring_frequency, d.spring_damping)], np.float32)

    @staticmethod
    def _offsets(p, ctx: JointContext):
        return ctx.orn_a.rotate(get3(p, 0)), ctx.orn_b.rotate(get3(p, 3))

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset_a, offset_b = BallSocket._offsets(p, ctx)
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        return apply_linear_offset_impulse(acc, offset_a, offset_b, ctx.inertia_a, ctx.inertia_b)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a, offset_b = BallSocket._offsets(p, ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 6), dt)
        eff = ball_socket_effective_mass(ctx.inertia_a, ctx.inertia_b, offset_a, offset_b, cfm)
        # error = (posB + offsetB) − (posA + offsetA); the bias counteracts separation.
        error = (ctx.pos_b - ctx.pos_a) + offset_b - offset_a
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        new_acc, dva, dvb = ball_socket_solve_iteration(
            ctx.vel_a, ctx.vel_b, offset_a, offset_b, error * err_to_vel, eff, softness, acc,
            ctx.inertia_a, ctx.inertia_b, ctx.active,
        )
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


class BallSocketServo:
    """Ball socket with servo speed/force limits (reference Constraints/BallSocketServo.cs).
    prestep: local_offset_a(3), local_offset_b(3), spring(2), servo(3). impulse: 3."""

    name = "ball_socket_servo"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"), ("spring", "spring"),
              ("servo", "servo"))
    N_PRESTEP = 11
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b,
             *spring_cols(d.spring_frequency, d.spring_damping), *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        return BallSocket.warm_start(p, imp, ctx)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a = ctx.orn_a.rotate(get3(p, 0))
        offset_b = ctx.orn_b.rotate(get3(p, 3))
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 6), dt)
        servo = get_servo(p, 8)
        eff = ball_socket_effective_mass(ctx.inertia_a, ctx.inertia_b, offset_a, offset_b, cfm)
        error = (ctx.pos_b - ctx.pos_a) + offset_b - offset_a
        bias, max_imp = servo_clamped_bias_vec3(error, err_to_vel, servo, dt, inv_dt)
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        new_acc, dva, dvb = ball_socket_solve_iteration(
            ctx.vel_a, ctx.vel_b, offset_a, offset_b, bias, eff, softness, acc,
            ctx.inertia_a, ctx.inertia_b, ctx.active, max_impulse=max_imp,
        )
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


class BallSocketMotor:
    """Drives relative velocity at anchors toward a target (reference
    Constraints/BallSocketMotor.cs). prestep: local_offset_b(3), target_velocity(3),
    motor(2). impulse: 3. The anchor on A is B's anchor position (shared grip point)."""

    name = "ball_socket_motor"
    FIELDS = (("local_offset_b", "vec3"), ("target_velocity", "vec3"), ("motor", "motor"))
    N_PRESTEP = 8
    N_IMPULSE = 3

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_b, *d.target_velocity, *motor_cols(d.motor)], np.float32
        )

    @staticmethod
    def _offsets(p, ctx: JointContext):
        offset_b = ctx.orn_b.rotate(get3(p, 0))
        # Anchor on A = world position of B's anchor, relative to A's center.
        offset_a = (ctx.pos_b - ctx.pos_a) + offset_b
        return offset_a, offset_b

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset_a, offset_b = BallSocketMotor._offsets(p, ctx)
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        return apply_linear_offset_impulse(acc, offset_a, offset_b, ctx.inertia_a, ctx.inertia_b)

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a, offset_b = BallSocketMotor._offsets(p, ctx)
        cfm, softness, max_imp = motor_softness(get_motor(p, 6), dt)
        eff = ball_socket_effective_mass(ctx.inertia_a, ctx.inertia_b, offset_a, offset_b, cfm)
        bias = get3(p, 3)  # target velocity of A's anchor relative to B
        acc = Vec3(imp[:, 0], imp[:, 1], imp[:, 2])
        new_acc, dva, dvb = ball_socket_solve_iteration(
            ctx.vel_a, ctx.vel_b, offset_a, offset_b, bias, eff, softness, acc,
            ctx.inertia_a, ctx.inertia_b, ctx.active, max_impulse=max_imp,
        )
        return torch.stack([new_acc.x, new_acc.y, new_acc.z], -1), dva, dvb


def _center_offset_jacobian(ctx: JointContext):
    """The center-to-center axis A to B and its length, +y where the centers meet (the
    center-distance family)."""
    ab = ctx.pos_b - ctx.pos_a
    dist = ab.length()
    axis = ab * torch.where(dist > 1e-9, 1.0 / dist.clamp_min(1e-9), 0.0)
    axis = axis.where(dist > 1e-9, full3(dist, 0.0, 1.0, 0.0))
    return ab, dist, axis


def _axis_1dof_solve(ctx: JointContext, axis: Vec3, bias, cfm, softness, acc):
    """Shared 1-DOF center-linear constraint along ``axis`` (jacobians: ±axis on linear,
    no angular). Used by CenterDistance (reference CenterDistanceConstraint.cs)."""
    inv_eff = ctx.inertia_a.inv_mass + ctx.inertia_b.inv_mass
    eff = safe_eff(cfm, inv_eff)
    csv = ctx.vel_a.linear.dot(axis) - ctx.vel_b.linear.dot(axis)
    corrective = (bias - csv) * eff - acc * softness
    new_acc = acc + corrective
    new_acc = torch.where(ctx.active, new_acc, acc)
    corrective = torch.where(ctx.active, new_acc - acc, 0.0)
    imp_v = axis * corrective
    dva = BodyVel(imp_v * ctx.inertia_a.inv_mass, zero3(corrective))
    dvb = BodyVel(-1.0 * imp_v * ctx.inertia_b.inv_mass, zero3(corrective))
    return new_acc, dva, dvb


class CenterDistance:
    """Keeps body centers at a target distance (reference
    Constraints/CenterDistanceConstraint.cs). prestep: target_distance(1), spring(2).
    impulse: 1."""

    name = "center_distance"
    FIELDS = (("target_distance", "scalar"), ("spring", "spring"))
    N_PRESTEP = 3
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [d.target_distance, *spring_cols(d.spring_frequency, d.spring_damping)], np.float32
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, _, axis = _center_offset_jacobian(ctx)
        imp_v = axis * imp[:, 0]
        dva = BodyVel(imp_v * ctx.inertia_a.inv_mass, zero3(imp[:, 0]))
        dvb = BodyVel(-1.0 * imp_v * ctx.inertia_b.inv_mass, zero3(imp[:, 0]))
        return dva, dvb

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        _, dist, axis = _center_offset_jacobian(ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 1), dt)
        # error > 0 when too far apart; the axis points A to B, so csv (A − B along it) is
        # positive while the bodies approach.
        error = dist - p[:, 0]
        bias = error * err_to_vel
        new_acc, dva, dvb = _axis_1dof_solve(ctx, axis, bias, cfm, softness, imp[:, 0])
        return new_acc[:, None], dva, dvb


class CenterDistanceLimit:
    """Center distance constrained to [min, max] (reference
    Constraints/CenterDistanceLimit.cs). prestep: min(1), max(1), spring(2). impulse: 1."""

    name = "center_distance_limit"
    FIELDS = (("minimum_distance", "scalar"), ("maximum_distance", "scalar"), ("spring", "spring"))
    N_PRESTEP = 4
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [d.minimum_distance, d.maximum_distance, *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        _, dist, axis = _center_offset_jacobian(ctx)
        use_min = dist - p[:, 0] < p[:, 1] - dist
        s = torch.where(use_min, -1.0, 1.0)
        imp_v = axis * (s * imp[:, 0])
        dva = BodyVel(imp_v * ctx.inertia_a.inv_mass, zero3(imp[:, 0]))
        dvb = BodyVel(-1.0 * imp_v * ctx.inertia_b.inv_mass, zero3(imp[:, 0]))
        return dva, dvb

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        _, dist, axis = _center_offset_jacobian(ctx)
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 2), dt)
        lo, hi = p[:, 0], p[:, 1]
        use_min = dist - lo < hi - dist
        # Satisfaction-space error e ≥ 0; side sign s maps csv (= −d(dist)/dt) to d(e)/dt.
        e = torch.where(use_min, dist - lo, hi - dist)
        s = torch.where(use_min, -1.0, 1.0)
        inv_eff = ctx.inertia_a.inv_mass + ctx.inertia_b.inv_mass
        eff = safe_eff(cfm, inv_eff)
        csv = ctx.vel_a.linear.dot(axis) - ctx.vel_b.linear.dot(axis)
        new_acc, csi = limit_solve_1dof(
            e, s * csv, eff, softness, imp[:, 0], inv_dt, err_to_vel, ctx.active
        )
        imp_v = axis * (s * csi)
        dva = BodyVel(imp_v * ctx.inertia_a.inv_mass, zero3(csi))
        dvb = BodyVel(-1.0 * imp_v * ctx.inertia_b.inv_mass, zero3(csi))
        return new_acc[:, None], dva, dvb


def _anchor_axis(ctx: JointContext, local_offset_a, local_offset_b):
    """World anchors and the anchor-to-anchor axis for the distance family."""
    offset_a = ctx.orn_a.rotate(local_offset_a)
    offset_b = ctx.orn_b.rotate(local_offset_b)
    anchor_ab = (ctx.pos_b - ctx.pos_a) + offset_b - offset_a  # A anchor → B anchor
    dist = anchor_ab.length()
    axis = anchor_ab * torch.where(dist > 1e-9, 1.0 / dist.clamp_min(1e-9), 0.0)
    axis = axis.where(dist > 1e-9, full3(dist, 0.0, 1.0, 0.0))
    return offset_a, offset_b, dist, axis


def _offset_1dof_solve(ctx, axis, offset_a, offset_b, bias, cfm, softness, acc, max_imp, active):
    """Shared 1-DOF solve for anchor constraints along ``axis`` with full offset jacobians:
    angularA = rA × axis, angularB = −(rB × axis)."""
    ang_a = offset_a.cross(axis)
    ang_b = offset_b.cross(axis)  # used with negative sign for B
    inv_eff = (
        ctx.inertia_a.inv_mass
        + ctx.inertia_b.inv_mass
        + ctx.inertia_a.inv_inertia.vector_sandwich(ang_a)
        + ctx.inertia_b.inv_inertia.vector_sandwich(ang_b)
    )
    eff = safe_eff(cfm, inv_eff)
    csv = (
        ctx.vel_a.linear.dot(axis)
        + ctx.vel_a.angular.dot(ang_a)
        - ctx.vel_b.linear.dot(axis)
        - ctx.vel_b.angular.dot(ang_b)
    )
    corrective = (bias - csv) * eff - acc * softness
    new_acc = acc + corrective
    if max_imp is not None:
        new_acc = torch.minimum(torch.maximum(new_acc, -max_imp), max_imp)
    new_acc = torch.where(active, new_acc, acc)
    corrective = torch.where(active, new_acc - acc, 0.0)
    lin = axis * corrective
    dva = BodyVel(lin * ctx.inertia_a.inv_mass, ctx.inertia_a.inv_inertia.transform(ang_a * corrective))
    dvb = BodyVel(
        -1.0 * lin * ctx.inertia_b.inv_mass,
        ctx.inertia_b.inv_inertia.transform(ang_b * (-corrective)),
    )
    return new_acc, dva, dvb


def _offset_1dof_warm(ctx, axis, offset_a, offset_b, acc):
    ang_a = offset_a.cross(axis)
    ang_b = offset_b.cross(axis)
    lin = axis * acc
    dva = BodyVel(lin * ctx.inertia_a.inv_mass, ctx.inertia_a.inv_inertia.transform(ang_a * acc))
    dvb = BodyVel(
        -1.0 * lin * ctx.inertia_b.inv_mass, ctx.inertia_b.inv_inertia.transform(ang_b * (-acc))
    )
    return dva, dvb


class DistanceServo:
    """Keeps anchor points at a target distance with servo limits (reference
    Constraints/DistanceServo.cs). prestep: local_offset_a(3), local_offset_b(3),
    target_distance(1), spring(2), servo(3). impulse: 1."""

    name = "distance_servo"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"),
              ("target_distance", "scalar"), ("spring", "spring"), ("servo", "servo"))
    N_PRESTEP = 12
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b, d.target_distance,
             *spring_cols(d.spring_frequency, d.spring_damping), *servo_cols(d.servo)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset_a, offset_b, dist, axis = _anchor_axis(ctx, get3(p, 0), get3(p, 3))
        return _offset_1dof_warm(ctx, axis, offset_a, offset_b, imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a, offset_b, dist, axis = _anchor_axis(ctx, get3(p, 0), get3(p, 3))
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 7), dt)
        servo = get_servo(p, 9)
        error = dist - p[:, 6]
        bias, max_imp = servo_clamped_bias_scalar(error, err_to_vel, servo, dt, inv_dt)
        new_acc, dva, dvb = _offset_1dof_solve(
            ctx, axis, offset_a, offset_b, bias, cfm, softness, imp[:, 0], max_imp, ctx.active
        )
        return new_acc[:, None], dva, dvb


class DistanceLimit:
    """Anchor distance within [min, max] (reference Constraints/DistanceLimit.cs).
    prestep: local_offset_a(3), local_offset_b(3), min(1), max(1), spring(2). impulse: 1."""

    name = "distance_limit"
    FIELDS = (("local_offset_a", "vec3"), ("local_offset_b", "vec3"),
              ("minimum_distance", "scalar"), ("maximum_distance", "scalar"),
              ("spring", "spring"))
    N_PRESTEP = 10
    N_IMPULSE = 1

    @staticmethod
    def pack(d) -> np.ndarray:
        return np.array(
            [*d.local_offset_a, *d.local_offset_b, d.minimum_distance, d.maximum_distance,
             *spring_cols(d.spring_frequency, d.spring_damping)],
            np.float32,
        )

    @staticmethod
    def warm_start(p, imp, ctx: JointContext):
        offset_a, offset_b, dist, axis = _anchor_axis(ctx, get3(p, 0), get3(p, 3))
        use_min = dist - p[:, 6] < p[:, 7] - dist
        s = torch.where(use_min, -1.0, 1.0)
        return _offset_1dof_warm(ctx, axis, offset_a, offset_b, s * imp[:, 0])

    @staticmethod
    def solve(p, imp, ctx: JointContext, dt, inv_dt):
        offset_a, offset_b, dist, axis = _anchor_axis(ctx, get3(p, 0), get3(p, 3))
        err_to_vel, cfm, softness = compute_springiness(get_spring(p, 8), dt)
        lo, hi = p[:, 6], p[:, 7]
        use_min = dist - lo < hi - dist
        e = torch.where(use_min, dist - lo, hi - dist)
        s = torch.where(use_min, -1.0, 1.0)
        ang_a = offset_a.cross(axis)
        ang_b = offset_b.cross(axis)
        inv_eff = (
            ctx.inertia_a.inv_mass
            + ctx.inertia_b.inv_mass
            + ctx.inertia_a.inv_inertia.vector_sandwich(ang_a)
            + ctx.inertia_b.inv_inertia.vector_sandwich(ang_b)
        )
        eff = safe_eff(cfm, inv_eff)
        csv = (
            ctx.vel_a.linear.dot(axis)
            + ctx.vel_a.angular.dot(ang_a)
            - ctx.vel_b.linear.dot(axis)
            - ctx.vel_b.angular.dot(ang_b)
        )
        new_acc, csi = limit_solve_1dof(
            e, s * csv, eff, softness, imp[:, 0], inv_dt, err_to_vel, ctx.active
        )
        applied = s * csi
        lin = axis * applied
        dva = BodyVel(lin * ctx.inertia_a.inv_mass, ctx.inertia_a.inv_inertia.transform(ang_a * applied))
        dvb = BodyVel(
            -1.0 * lin * ctx.inertia_b.inv_mass,
            ctx.inertia_b.inv_inertia.transform(ang_b * (-applied)),
        )
        return new_acc[:, None], dva, dvb
