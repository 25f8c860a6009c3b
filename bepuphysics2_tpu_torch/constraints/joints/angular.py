"""Angular joint family: SwingLimit (the only one of the family the port carries yet).

Counterpart of ``SwingLimit`` in ``bepuphysics2_tpu/constraints/joints/angular.py``
(reference Constraints/SwingLimit.cs).
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Vec3, build_orthonormal_basis
from ..contact import BodyVel
from .base import JointContext, get3, get_spring, spring_cols


def _angular_1dof_apply(ctx: JointContext, jac: Vec3, csi):
    """Equal-and-opposite angular impulse csi along jacobian jac."""
    imp = jac * csi
    z = Vec3.zeros(csi.shape, device=csi.device)
    dva = BodyVel(z, ctx.inertia_a.inv_inertia.transform(imp))
    dvb = BodyVel(z, -1.0 * ctx.inertia_b.inv_inertia.transform(imp))
    return dva, dvb


def _angular_1dof_effective_mass(ctx: JointContext, jac: Vec3):
    return (ctx.inertia_a.inv_inertia.vector_sandwich(jac)
            + ctx.inertia_b.inv_inertia.vector_sandwich(jac))


def _safe_eff(cfm, inv_eff):
    """cfm / inv_eff with the zero-total-inverse-mass guard (a joint between two
    locked-inertia bodies moves nothing; raw division would give NaN velocities)."""
    return torch.where(inv_eff > 0.0, cfm / inv_eff.clamp_min(1e-30), 0.0)


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
        min_dot = (float(np.cos(d.maximum_swing_angle)) if hasattr(d, "maximum_swing_angle")
                   else d.minimum_dot)
        return np.array([*d.axis_local_a, *d.axis_local_b, min_dot,
                         *spring_cols(d.spring_frequency, d.spring_damping)], np.float32)

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
        eff = _safe_eff(cfm, _angular_1dof_effective_mass(ctx, jac))
        error = axis_a.dot(axis_b) - p[:, 6]
        bias = -torch.minimum(error * inv_dt, error * err_to_vel)
        csv = (ctx.vel_a.angular - ctx.vel_b.angular).dot(jac)
        csi = eff * (bias - csv) - imp[:, 0] * softness
        new_acc = torch.clamp_min(imp[:, 0] + csi, 0.0)
        new_acc = torch.where(ctx.active, new_acc, imp[:, 0])
        csi = torch.where(ctx.active, new_acc - imp[:, 0], 0.0)
        dva, dvb = _angular_1dof_apply(ctx, jac, csi)
        return new_acc[:, None], dva, dvb
