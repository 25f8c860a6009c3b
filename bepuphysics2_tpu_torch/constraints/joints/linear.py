"""Linear joint family: BallSocket (the only one of the family the port carries yet).

Counterpart of ``BallSocket`` in ``bepuphysics2_tpu/constraints/joints/linear.py``
(reference Constraints/BallSocket.cs:66). A joint class is a namespace of static
functions over SoA columns (see ``base``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils.spring import compute_springiness
from ...utils.vec import Vec3
from .base import (
    JointContext,
    apply_linear_offset_impulse,
    ball_socket_effective_mass,
    ball_socket_solve_iteration,
    get3,
    get_spring,
    spring_cols,
)


def _safe_eff(cfm, inv_eff):
    """cfm / inv_eff guarded for zero total inverse mass (raw division gives inf, then
    NaN velocities)."""
    return torch.where(inv_eff > 0.0, cfm / inv_eff.clamp_min(1e-30), 0.0)


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
