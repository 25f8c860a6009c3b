"""Pose/velocity integration over all bodies, all three angular modes.

Counterpart of ``bepuphysics2_tpu/integrator.py`` (reference PoseIntegrator.cs:23,
122-255, 424, 707). The port leaves out ``velocity_callback``: a config that sets one is
refused by the step (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .bodies import BodyState
from .utils.vec import Mat3, Quat, Sym3, Vec3, integrate_orientation

ANGULAR_NONCONSERVING = 0
ANGULAR_CONSERVE_MOMENTUM = 1
ANGULAR_CONSERVE_WITH_GYROSCOPIC = 2


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """Pose-integrator settings (reference IPoseIntegratorCallbacks, PoseIntegrator.cs:42)."""

    gravity: tuple = (0.0, -10.0, 0.0)
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    angular_mode: int = ANGULAR_NONCONSERVING
    # Kept so configs carry across from the JAX package; the port refuses a non-None
    # callback (not ported yet).
    velocity_callback: Optional[Callable] = None


def _fallback_if_incompatible(prev: Vec3, new: Vec3) -> Vec3:
    """Keep the previous angular velocity where momentum conservation went non-finite."""
    inf = float("inf")
    ok = (new.x.abs() < inf) & (new.y.abs() < inf) & (new.z.abs() < inf)
    return new.where(ok, prev)


def integrate_angular_conserve_momentum(
    prev_orn: Quat, local_inv_inertia: Sym3, world_inv_inertia: Sym3, omega: Vec3
) -> Vec3:
    """L = R_prev^T I_local R_prev ω held constant; ω' = I_world^-1 L."""
    r_prev = prev_orn.to_matrix()
    local_omega = r_prev.transform_transpose(omega)
    local_inertia = local_inv_inertia.inverse()
    local_momentum = local_inertia.transform(local_omega)
    momentum = r_prev.transform(local_momentum)
    new_omega = world_inv_inertia.transform(momentum)
    return _fallback_if_incompatible(omega, new_omega)


def integrate_angular_gyroscopic(orn: Quat, local_inv_inertia: Sym3, omega: Vec3, dt) -> Vec3:
    """Implicit gyroscopic torque via one local-frame Newton step."""
    r = orn.to_matrix()
    local_omega = r.transform_transpose(omega)
    local_inertia = local_inv_inertia.inverse()
    local_momentum = local_inertia.transform(local_omega)
    residual = local_momentum.cross(local_omega) * dt

    skew_momentum = Mat3.cross_matrix(local_momentum)
    skew_velocity = Mat3.cross_matrix(local_omega)
    inertia_m = Mat3(
        Vec3(local_inertia.xx, local_inertia.yx, local_inertia.zx),
        Vec3(local_inertia.yx, local_inertia.yy, local_inertia.zy),
        Vec3(local_inertia.zx, local_inertia.zy, local_inertia.zz),
    )
    change = (skew_velocity.matmul(inertia_m) - skew_momentum) * dt
    jacobian = inertia_m + change
    newton_step = jacobian.inverse().transform(residual)
    local_omega = local_omega - newton_step
    new_omega = r.transform(local_omega)
    return _fallback_if_incompatible(omega, new_omega)


def integrate_velocities(state: BodyState, cfg: IntegratorConfig, dt) -> BodyState:
    """One substep of velocity integration (gravity, damping) for awake dynamics."""
    if cfg.velocity_callback is not None:
        raise NotImplementedError("velocity_callback is not ported yet (ROADMAP queue 1 item 11)")
    mask = (state.kind == 1) & state.awake
    g = Vec3(
        torch.full_like(state.vel.x, cfg.gravity[0]),
        torch.full_like(state.vel.x, cfg.gravity[1]),
        torch.full_like(state.vel.x, cfg.gravity[2]),
    )
    lin_scale = (1.0 - cfg.linear_damping) ** dt if cfg.linear_damping else 1.0
    ang_scale = (1.0 - cfg.angular_damping) ** dt if cfg.angular_damping else 1.0
    new_vel = (state.vel + g * dt) * lin_scale
    new_omega = state.omega * ang_scale
    return state._replace(
        vel=new_vel.where(mask, state.vel),
        omega=new_omega.where(mask, state.omega),
    )


def integrate_poses(state: BodyState, cfg: IntegratorConfig, dt) -> BodyState:
    """One substep of pose integration for integrable bodies; the angular-mode velocity
    adjustment runs after the orientation update (PoseIntegrator.cs:652-666)."""
    mask = state.integrable
    new_pos = state.pos + state.vel * dt
    new_orn = integrate_orientation(state.orn, state.omega, dt)

    omega = state.omega
    if cfg.angular_mode == ANGULAR_CONSERVE_MOMENTUM:
        world_inv_inertia = state.inv_inertia.rotation_sandwich(new_orn.to_matrix())
        omega_c = integrate_angular_conserve_momentum(
            state.orn, state.inv_inertia, world_inv_inertia, state.omega
        )
        omega = omega_c.where(mask & (state.kind == 1), state.omega)
    elif cfg.angular_mode == ANGULAR_CONSERVE_WITH_GYROSCOPIC:
        omega_c = integrate_angular_gyroscopic(new_orn, state.inv_inertia, state.omega, dt)
        omega = omega_c.where(mask & (state.kind == 1), state.omega)

    return state._replace(
        pos=new_pos.where(mask, state.pos),
        orn=new_orn.where(mask, state.orn),
        omega=omega,
    )
