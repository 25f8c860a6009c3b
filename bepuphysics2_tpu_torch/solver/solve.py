"""Substepped TGS solver: the store fast path over kernel K1.

Counterpart of ``SolveConfig`` and the full-width branch of ``_solve_store_fast`` in
``bepuphysics2_tpu/solver/solve.py`` (reference Solver_Solve.cs:1415): the slot-order
prestep and impulses pack once, move once into page-execution order (pages by color,
Jacobi pages last), the whole substepped solve runs in K1, and a final pose integration
follows. The port always takes this path; the bucketed and XLA paths, the windowed layout
and joints are not ported yet (ROADMAP queues 1 and 2), and ``solve_all`` refuses a scene
that would need them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bodies import BodyState, KIND_DYNAMIC
from ..integrator import IntegratorConfig, integrate_poses
from ..ops import sweep as psweep
from ..utils.spring import compute_springiness
from ..utils.vec import Vec3


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """reference SolveDescription (SolveDescription.cs:17). Fields match the JAX config;
    the port reads substeps, velocity_iterations and num_colors."""

    substeps: int = 8
    velocity_iterations: int = 1
    num_colors: int = 8
    color_cap_factor: float = 1.5
    color_rounds: int = 3
    color_churn_cap: int = None
    jacobi_cap_factor: float = 0.3
    iteration_schedule: tuple = None
    backend: str = "auto"
    wide_cap_rows: int = 0


def substep_scalars(dt, substeps: int):
    """(h, inv_h) as float32 values, as the JAX solver computes them from an f32 dt."""
    dt32 = np.float32(dt)
    return float(dt32 / np.float32(substeps)), float(np.float32(substeps) / dt32)


def _vel_to6(state: BodyState) -> torch.Tensor:
    return torch.stack([*state.vel, *state.omega], -1)


def _vel_from6(state: BodyState, v6: torch.Tensor) -> BodyState:
    return state._replace(vel=Vec3(v6[:, 0], v6[:, 1], v6[:, 2]),
                          omega=Vec3(v6[:, 3], v6[:, 4], v6[:, 5]))


def _solve_store_fast(state, store_bank, integrator_cfg, cfg, dt):
    """Whole-solve fast path for store-only scenes (full-width branch): pack the
    slot-order prestep + impulses into one (B, 42) matrix, permute its pages into
    execution order, run K1, and bring the impulses back to slot order."""
    from ..collision import pairstore as _ps

    h, inv_h = substep_scalars(dt, cfg.substeps)
    C = cfg.num_colors
    st = store_bank["store"]
    sps = store_bank["ps"]
    simp0 = store_bank["imp"]
    active = store_bank["active"]
    n_bodies = state.pos.x.shape[0]
    B = st.capacity

    jac_slot = active & (st.color == C)
    is_jac = st.color == C

    fvalid = sps.valid.float()
    psc = psweep.pack_contact_prestep_cols(sps, compute_springiness(sps.spring, h))
    imc = psweep.pack_contact_impulses_cols(simp0) * fvalid[:, None]

    lin_scale = (1.0 - integrator_cfg.linear_damping) ** h if integrator_cfg.linear_damping else 1.0
    ang_scale = (1.0 - integrator_cfg.angular_damping) ** h if integrator_cfg.angular_damping else 1.0
    gmask = (state.kind == KIND_DYNAMIC) & state.awake

    # Mass-split valence of Jacobi rows (reference SequentialFallbackBatch.cs:37),
    # maintained incrementally by the store.
    valence = st.jacv[:n_bodies].clamp_min(1.0)
    sa = torch.where(is_jac, valence[st.body_a.long()], 1.0)
    sb_scale = torch.where(is_jac, valence[st.body_b.long()], 1.0)
    M = torch.cat([psc, imc, sa[:, None], sb_scale[:, None]], dim=-1)
    page = st.page
    P = st.n_pages
    perm_pages, _, inv_perm = _ps.exec_order(st, C)
    pp = perm_pages.long()
    Mx = M.reshape(P, page, M.shape[1])[pp].reshape(B, M.shape[1])
    Ix = torch.stack([st.body_a, st.body_b], -1).reshape(P, page, 2)[pp].reshape(B, 2)
    # Padding rows carry zero scales; they read 1 (real Jacobi scales are >= 1).
    sa_x = torch.where(Mx[:, 40] == 0, 1.0, Mx[:, 40])
    sb_x = torch.where(Mx[:, 41] == 0, 1.0, Mx[:, 41])
    nsl = B // page
    idx2 = torch.cat([Ix[:, 0].reshape(nsl, page), Ix[:, 1].reshape(nsl, page)], 1).reshape(-1)
    scale = torch.cat([sa_x.reshape(nsl, page), sb_x.reshape(nsl, page)], 1).reshape(-1)
    ps_t = Mx[:, :32].T.contiguous()
    imp_t = Mx[:, 32:40].T.contiguous()
    c = lambda t: t.contiguous()
    v6n, pos_n, orn_n, imp_out = psweep.solve_substeps_contacts(
        _vel_to6(state), type(state.pos)(*map(c, state.pos)), type(state.orn)(*map(c, state.orn)),
        c(state.inv_mass), type(state.inv_inertia)(*map(c, state.inv_inertia)),
        gmask, state.integrable, ps_t, imp_t, idx2.to(torch.int32).contiguous(),
        scale.contiguous(), h, inv_h, lin_scale, ang_scale,
        sb=page, n_substeps=cfg.substeps, n_iters=cfg.velocity_iterations,
        angular_mode=integrator_cfg.angular_mode, gravity=integrator_cfg.gravity,
    )
    state = _vel_from6(state._replace(pos=pos_n, orn=orn_n), v6n)
    imp_rows = imp_out.T.reshape(P, page, 8)[inv_perm.long()].reshape(B, 8)

    state = integrate_poses(state, integrator_cfg, h)
    imp_slot = simp0._replace(
        penetration=imp_rows[:, :4],
        tangent=simp0.tangent._replace(x=imp_rows[:, 4], y=imp_rows[:, 5]),
        twist=imp_rows[:, 6],
    )
    demand = torch.stack([jac_slot.sum(), torch.zeros_like(jac_slot.sum())]).to(torch.int32)
    overflow = torch.zeros((), dtype=torch.bool, device=jac_slot.device)
    return state, [imp_slot], {}, overflow, [], {}, demand


def solve_all(
    state: BodyState,
    contact_banks,
    joint_banks: dict,
    integrator_cfg: IntegratorConfig,
    cfg: SolveConfig,
    dt,
    axis_name: str = None,
    store_bank: dict = None,
    base_used=None,
):
    """Full substepped solve. The port solves store-only contact scenes through K1 and
    refuses every other bank shape. Returns (state, [impulses], {joint impulses},
    overflow, [colors], {joint colors}, demand (2,) [Jacobi rows, wide rows])."""
    if axis_name is not None:
        raise NotImplementedError("sharded solve is not ported yet (ROADMAP queue 1 item 23)")
    if joint_banks:
        raise NotImplementedError("joints are not ported yet (ROADMAP queue 1 items 15-16)")
    if contact_banks:
        raise NotImplementedError(
            "contact banks outside the pair store are not ported yet (ROADMAP queue 1 item 18)")
    if store_bank is None:
        raise NotImplementedError("the port solves through the pair store only (ROADMAP queue 1 item 15)")
    if cfg.iteration_schedule is not None:
        raise NotImplementedError("iteration schedules are not ported yet (ROADMAP queue 1 item 11)")
    if integrator_cfg.velocity_callback is not None:
        raise NotImplementedError("velocity_callback is not ported yet (ROADMAP queue 1 item 11)")
    return _solve_store_fast(state, store_bank, integrator_cfg, cfg, dt)
