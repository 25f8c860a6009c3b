"""Joint constraint framework: per-type fixed-capacity banks and the shared solve helpers.

Counterpart of ``bepuphysics2_tpu/constraints/joints/base.py`` (reference
Constraints/*.cs, TypeProcessor.cs:23). Each joint type provides:
  - ``N_PRESTEP`` / ``N_IMPULSE``: float columns of prestep / accumulated-impulse storage
  - ``pack(desc) -> np.ndarray[N_PRESTEP]``: host-side description → prestep row
  - ``warm_start(prestep, imp, ctx) -> (dva, dvb)``: velocity deltas from accumulated imp
  - ``solve(prestep, imp, ctx, dt, inv_dt) -> (imp', dva, dvb)``

with ``ctx: JointContext`` carrying gathered pose, velocity and inertia for both bodies.
``solve`` masks its impulse bookkeeping by ``ctx.active``; warm start may assume the
impulses of inactive records are zero.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ...utils.spring import SpringSettings
from ...utils.vec import Quat, Sym3, Vec2, Vec3
from ..contact import BodyVel, GatheredInertia


class JointContext(NamedTuple):
    """Gathered per-record state for a joint bank pass."""

    pos_a: Vec3
    orn_a: Quat
    inertia_a: GatheredInertia
    vel_a: BodyVel
    pos_b: Vec3
    orn_b: Quat
    inertia_b: GatheredInertia
    vel_b: BodyVel
    active: torch.Tensor  # (M,) bool: record live and in the current color


class JointBank(NamedTuple):
    """Device-side storage of one joint type."""

    body_a: torch.Tensor  # (M,) int32
    body_b: torch.Tensor  # (M,) int32
    valid: torch.Tensor  # (M,) bool
    prestep: torch.Tensor  # (M, N_PRESTEP) f32
    impulse: torch.Tensor  # (M, N_IMPULSE) f32

    @staticmethod
    def empty(capacity: int, n_prestep: int, n_impulse: int, device=None) -> "JointBank":
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
        return JointBank(z(capacity, dt=torch.int32), z(capacity, dt=torch.int32),
                         z(capacity, dt=torch.bool), z(capacity, n_prestep),
                         z(capacity, n_impulse))


# --- column (de)serialization helpers for prestep packing ------------------------------

def get3(p, i) -> Vec3:
    return Vec3(p[:, i], p[:, i + 1], p[:, i + 2])


def get_quat(p, i) -> Quat:
    return Quat(p[:, i], p[:, i + 1], p[:, i + 2], p[:, i + 3])


def get_spring(p, i) -> SpringSettings:
    return SpringSettings(p[:, i], p[:, i + 1])


def spring_cols(spring_frequency: float, damping_ratio: float):
    return [spring_frequency * 2.0 * np.pi, damping_ratio * 2.0]


def servo_cols(servo) -> list:
    """servo: ServoSettingsDesc."""
    return [servo.maximum_speed, servo.base_speed, servo.maximum_force]


def motor_cols(motor) -> list:
    return [motor.maximum_force, 0.0 if motor.softness <= 0 else 1.0 / motor.softness]


def unpack_fields(cls, row) -> dict:
    """Inverse of ``pack`` for FIELDS-declared joint types: prestep row → description
    kwargs (reference Solver.GetDescription, Solver.cs:1413). Column inverses run in
    float64 so repacking reproduces the row bit-exactly."""
    out = {}
    i = 0
    for name, kind in cls.FIELDS:
        if kind == "vec3":
            out[name] = tuple(float(v) for v in row[i:i + 3])
            i += 3
        elif kind == "quat":
            out[name] = tuple(float(v) for v in row[i:i + 4])
            i += 4
        elif kind == "scalar":
            out[name] = float(row[i])
            i += 1
        elif kind == "spring":
            out["spring_frequency"] = float(row[i]) / (2.0 * np.pi)
            out["spring_damping"] = float(row[i + 1]) / 2.0
            i += 2
        elif kind == "servo":
            out["servo"] = ServoSettingsDesc(float(row[i]), float(row[i + 1]), float(row[i + 2]))
            i += 3
        elif kind == "motor":
            inv = float(row[i + 1])
            out["motor"] = MotorSettingsDesc(float(row[i]), 0.0 if inv == 0.0 else 1.0 / inv)
            i += 2
        else:  # pragma: no cover
            raise ValueError(f"unknown field kind {kind}")
    if i != cls.N_PRESTEP:
        raise AssertionError(f"{cls.name}: FIELDS covers {i} columns, N_PRESTEP is {cls.N_PRESTEP}")
    return out


@dataclasses.dataclass
class ServoSettingsDesc:
    """reference ServoSettings (Constraints/ServoSettings.cs)."""

    maximum_speed: float = 3.0e38
    base_speed: float = 0.0
    maximum_force: float = 3.0e38


@dataclasses.dataclass
class MotorSettingsDesc:
    """reference MotorSettings (Constraints/MotorSettings.cs)."""

    maximum_force: float = 3.0e38
    softness: float = 0.01  # 1/damping


class ServoParams(NamedTuple):
    maximum_speed: torch.Tensor
    base_speed: torch.Tensor
    maximum_force: torch.Tensor


def get_servo(p, i) -> ServoParams:
    return ServoParams(p[:, i], p[:, i + 1], p[:, i + 2])


class MotorParams(NamedTuple):
    maximum_force: torch.Tensor
    damping: torch.Tensor


def get_motor(p, i) -> MotorParams:
    return MotorParams(p[:, i], p[:, i + 1])


def motor_softness(motor: MotorParams, dt):
    """reference MotorSettingsWide.ComputeSoftness: (effective_mass_cfm_scale,
    softness_impulse_scale, maximum_impulse)."""
    dtd = dt * motor.damping
    maximum_impulse = motor.maximum_force * dt
    softness_impulse_scale = 1.0 / (dtd + 1.0)
    effective_mass_cfm_scale = dtd * softness_impulse_scale
    return effective_mass_cfm_scale, softness_impulse_scale, maximum_impulse


def servo_clamped_bias_scalar(error, pos_err_to_vel, servo: ServoParams, dt, inv_dt):
    """reference ServoSettingsWide.ComputeClampedBiasVelocity (scalar error)."""
    base_speed = torch.minimum(servo.base_speed, error.abs() * inv_dt)
    bias = error * pos_err_to_vel
    clamped = torch.where(
        bias < 0.0,
        torch.maximum(-servo.maximum_speed, torch.minimum(-base_speed, bias)),
        torch.minimum(servo.maximum_speed, torch.maximum(base_speed, bias)),
    )
    return clamped, servo.maximum_force * dt


def servo_clamped_bias_vec3(error: Vec3, pos_err_to_vel, servo: ServoParams, dt, inv_dt):
    """reference ServoSettingsWide.ComputeClampedBiasVelocity (Vec3 error)."""
    err_len = error.length()
    axis = error * torch.where(err_len > 1e-10, 1.0 / err_len.clamp_min(1e-10), 0.0)
    base_speed = torch.minimum(servo.base_speed, err_len * inv_dt)
    unclamped = err_len * pos_err_to_vel
    target = torch.maximum(base_speed, unclamped)
    scale = torch.where(target < 1e-10, 1.0,
                        torch.clamp_max(servo.maximum_speed / target.clamp_min(1e-10), 1.0))
    return axis * (scale * torch.maximum(unclamped, base_speed)), servo.maximum_force * dt


def clamp_impulse_scalar(max_impulse, accumulated, corrective):
    """Clamp |accumulated| ≤ max; returns (accumulated', corrective')
    (reference ServoSettingsWide.ClampImpulse)."""
    new_acc = torch.minimum(torch.maximum(accumulated + corrective, -max_impulse), max_impulse)
    return new_acc, new_acc - accumulated


def clamp_impulse_vec3(max_impulse, accumulated: Vec3, corrective: Vec3):
    new_acc = accumulated + corrective
    scale = torch.clamp_max(max_impulse / new_acc.length().clamp_min(1e-16), 1.0)
    new_acc = new_acc * scale
    return new_acc, new_acc - accumulated


def clamp_impulse_vec2(max_impulse, accumulated: Vec2, corrective: Vec2):
    nx = accumulated.x + corrective.x
    ny = accumulated.y + corrective.y
    mag = torch.sqrt(nx * nx + ny * ny)
    scale = torch.clamp_max(max_impulse / mag.clamp_min(1e-16), 1.0)
    nx = nx * scale
    ny = ny * scale
    return Vec2(nx, ny), Vec2(nx - accumulated.x, ny - accumulated.y)


def limit_solve_1dof(e, csv_e, eff, softness, acc, inv_dt, err_to_vel, active):
    """Shared inequality limit solve in satisfaction space: e ≥ 0 is the constraint,
    ``csv_e`` = de/dt from velocities, accumulated impulse nonnegative (reference
    SwingLimit.Solve / InequalityHelpers.ClampPositive). Returns (acc', csi)."""
    bias = -torch.minimum(e * inv_dt, e * err_to_vel)
    csi = eff * (bias - csv_e) - acc * softness
    new_acc = torch.clamp_min(acc + csi, 0.0)
    new_acc = torch.where(active, new_acc, acc)
    return new_acc, torch.where(active, new_acc - acc, 0.0)


# --- shared jacobian application helpers ----------------------------------------------

def zero_dv(n, device=None) -> BodyVel:
    return BodyVel(Vec3.zeros(n, device=device), Vec3.zeros(n, device=device))


def zero3(like: torch.Tensor) -> Vec3:
    """A zero Vec3 of ``like``'s shape on its device."""
    return Vec3.zeros(like.shape, device=like.device)


def full3(like: torch.Tensor, x: float, y: float, z: float) -> Vec3:
    """The constant Vec3 (x, y, z) of ``like``'s shape on its device."""
    return Vec3.full(like.shape, x, y, z, device=like.device)


def safe_eff(cfm, inv_eff):
    """cfm / inv_eff guarded for zero total inverse mass (a joint between two
    locked-inertia bodies moves nothing; raw division gives inf, then NaN velocities)."""
    return torch.where(inv_eff > 0.0, cfm / inv_eff.clamp_min(1e-30), 0.0)


def apply_linear_offset_impulse(impulse: Vec3, offset_a: Vec3, offset_b: Vec3,
                                ia: GatheredInertia, ib: GatheredInertia):
    """A world-space linear impulse acting at offsets (the ball-socket jacobian):
    ΔvA = +imp/mA, ΔwA = IA⁻¹ (rA × imp), ΔvB = −imp/mB, ΔwB = IB⁻¹ (imp × rB)
    (reference BallSocketShared.ApplyImpulse)."""
    dva = BodyVel(impulse * ia.inv_mass, ia.inv_inertia.transform(offset_a.cross(impulse)))
    dvb = BodyVel(-1.0 * impulse * ib.inv_mass, ib.inv_inertia.transform(impulse.cross(offset_b)))
    return dva, dvb


def apply_angular_impulse(impulse: Vec3, ia: GatheredInertia, ib: GatheredInertia):
    """Pure angular impulse, equal and opposite (jacobian I / −I on angular DOFs)."""
    z = Vec3.zeros(impulse.x.shape, device=impulse.x.device)
    return (BodyVel(z, ia.inv_inertia.transform(impulse)),
            BodyVel(z, -1.0 * ib.inv_inertia.transform(impulse)))


def ball_socket_effective_mass(ia: GatheredInertia, ib: GatheredInertia, offset_a: Vec3,
                               offset_b: Vec3, cfm_scale) -> Sym3:
    """(J M⁻¹ Jᵀ)⁻¹ · cfm for the ball-socket jacobian (reference
    BallSocketShared.ComputeEffectiveMass)."""
    inv_eff = ia.inv_inertia.skew_sandwich(offset_a) + ib.inv_inertia.skew_sandwich(offset_b)
    lin = ia.inv_mass + ib.inv_mass
    inv_eff = Sym3(inv_eff.xx + lin, inv_eff.yx, inv_eff.yy + lin, inv_eff.zx, inv_eff.zy,
                   inv_eff.zz + lin)
    return inv_eff.inverse() * cfm_scale


def ball_socket_csv(va: BodyVel, vb: BodyVel, offset_a: Vec3, offset_b: Vec3) -> Vec3:
    """Constraint-space velocity of the ball socket: vA + wA×rA − vB − wB×rB."""
    return va.linear + va.angular.cross(offset_a) - vb.linear - vb.angular.cross(offset_b)


def ball_socket_solve_iteration(va: BodyVel, vb: BodyVel, offset_a: Vec3, offset_b: Vec3,
                                bias: Vec3, effective_mass: Sym3, softness_impulse_scale,
                                accumulated: Vec3, ia: GatheredInertia, ib: GatheredInertia,
                                active, max_impulse=None):
    """One iteration of the shared ball-socket solve (reference BallSocketShared.Solve).
    Returns (accumulated', dva, dvb)."""
    csv = ball_socket_csv(va, vb, offset_a, offset_b)
    corrective = effective_mass.transform(bias - csv) - accumulated * softness_impulse_scale
    if max_impulse is None:
        new_acc = accumulated + corrective
    else:
        new_acc, corrective = clamp_impulse_vec3(max_impulse, accumulated, corrective)
    new_acc = new_acc.where(active, accumulated)
    corrective = (new_acc - accumulated).where(
        active, Vec3.zeros(active.shape, device=active.device))
    dva, dvb = apply_linear_offset_impulse(corrective, offset_a, offset_b, ia, ib)
    return new_acc, dva, dvb
