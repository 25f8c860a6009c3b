"""Substepped TGS solver: the store fast path over kernels K1 and K2.

Counterpart of ``SolveConfig`` and ``_solve_store_fast`` in
``bepuphysics2_tpu/solver/solve.py`` (reference Solver_Solve.cs:1415): the slot-order
prestep and impulses pack once and move once into the execution layout, the whole
substepped solve runs in one kernel, and a final pose integration follows. Up to 8,192
bodies the layout is the page-execution order (pages by color, Jacobi pages last) and
the kernel is K1; above that, or with ``backend="pallas_win"``, it is the windowed layout
of ``windowing.py`` and the kernel is K2. The bucketed path and joints are not ported yet
(ROADMAP queue 1), and ``solve_all`` refuses a scene that would need them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bodies import BodyState, KIND_DYNAMIC
from ..collision.pairstore import _compact
from ..integrator import IntegratorConfig, integrate_poses
from ..ops import sweep as psweep
from ..utils.spring import compute_springiness
from ..utils.vec import Quat, Sym3, Vec3
from . import windowing

SB_WIN = 256  # rows per windowed slice


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


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _wide_counts(wide_row, body_a, body_b, n_bodies: int, wide_cap: int):
    """(n_bodies + 1,) f32 per-body count of wide rows (mass-split writer valence). Rows
    past ``wide_cap`` sink and never solve, so only the first ``wide_cap`` count."""
    B = wide_row.shape[0]
    wsel, _, _ = _compact(wide_row, wide_cap)
    wl = wsel < B
    wc = torch.clamp_max(wsel, B - 1).long()
    one = wl.float()
    out = torch.zeros(n_bodies + 1, dtype=torch.float32, device=wide_row.device)
    out.index_add_(0, torch.where(wl, body_a[wc], n_bodies).long(), one)
    return out.index_add_(0, torch.where(wl, body_b[wc], n_bodies).long(), one)


def win_pack(pos, kind, body_a, body_b, valid, color, jacv, M, num_colors: int,
             wide_cap: int):
    """The windowed execution view of one slot-order bank: the body layout, the row
    windows, and K2's bank arguments. ``M`` (B, 40) holds the packed prestep (32) and
    impulse (8) columns; ``jacv`` the store's per-body Jacobi valence. Mass-split rows are
    the Jacobi-colored rows and the wide rows (wide slices mix colors); a body's scale is
    its Jacobi valence plus its wide-row count. Returns a dict with ``lay``, ``rw`` and
    the arguments ``ps_t``, ``imp_t``, ``whi2``, ``wlo2``, ``scale``, ``wseg``."""
    n_bodies = kind.shape[0]
    C = num_colors
    sb = SB_WIN
    lay = windowing.body_layout(pos, kind)
    rw = windowing.row_windows(lay, body_a, body_b, valid, color, C, sb, wide_cap)
    bp, nsl = rw["bp"], rw["n_slices"]
    wct = _wide_counts(rw["wide"], body_a, body_b, n_bodies, wide_cap)
    split_val = torch.clamp_min(jacv[:n_bodies] + wct[:n_bodies], 1.0)
    split_row = (color == C) | rw["wide"]
    sa = torch.where(split_row, split_val[body_a.long()], 1.0)
    sbs = torch.where(split_row, split_val[body_b.long()], 1.0)
    Mw = windowing.scatter_rows(rw["dest"], bp, torch.cat(
        [M, sa[:, None], sbs[:, None], rw["rel_a"][:, None].float(),
         rw["rel_b"][:, None].float()], -1))
    # Padding rows scattered as zero: their scales read 1 (real scales are >= 1).
    sa_w = torch.where(Mw[:, 40] == 0, 1.0, Mw[:, 40])
    sb_w = torch.where(Mw[:, 41] == 0, 1.0, Mw[:, 41])
    rel_a = Mw[:, 42].to(torch.int32)
    rel_b = Mw[:, 43].to(torch.int32)

    def slice_major(xa, xb):
        return torch.cat([xa.reshape(nsl, sb), xb.reshape(nsl, sb)], 1).reshape(-1).contiguous()

    L = psweep.L
    # K2's state: 8 impulse rows, the 4 initial depths (prestep columns 18-21), 4 unused.
    imp_t = torch.cat([Mw[:, 32:40], Mw[:, 18:22],
                       torch.zeros((bp, 4), dtype=torch.float32, device=Mw.device)], -1)
    return dict(
        lay=lay, rw=rw, ps_t=Mw[:, :32].T.contiguous(), imp_t=imp_t.T.contiguous(),
        whi2=slice_major(torch.div(rel_a, L, rounding_mode="floor"),
                         torch.div(rel_b, L, rounding_mode="floor")),
        wlo2=slice_major(torch.remainder(rel_a, L), torch.remainder(rel_b, L)),
        scale=slice_major(sa_w, sb_w), wseg=rw["wseg"].contiguous(),
    )


def _solve_store_fast(state, store_bank, integrator_cfg, cfg, dt, use_win: bool):
    """Whole-solve fast path for store-only scenes: pack the slot-order prestep and
    impulses into one (B, 40) matrix, move it once into the execution layout, run the
    whole substepped solve in one kernel, and bring the impulses back to slot order.
    ``use_win`` picks the windowed layout and K2 over the page order and K1."""
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
    M = torch.cat([psc, imc], -1)

    lin_scale = (1.0 - integrator_cfg.linear_damping) ** h if integrator_cfg.linear_damping else 1.0
    ang_scale = (1.0 - integrator_cfg.angular_damping) ** h if integrator_cfg.angular_damping else 1.0
    gmask = (state.kind == KIND_DYNAMIC) & state.awake
    c = lambda t: t.contiguous()
    kw = dict(n_substeps=cfg.substeps, n_iters=cfg.velocity_iterations,
              angular_mode=integrator_cfg.angular_mode, gravity=integrator_cfg.gravity)

    if use_win:
        wide_cap = max(SB_WIN, _round_up(cfg.wide_cap_rows or B // 8, SB_WIN))
        wp = win_pack(state.pos, state.kind, st.body_a, st.body_b, sps.valid, st.color,
                      st.jacv, M, C, wide_cap)
        lay, rw = wp["lay"], wp["rw"]
        pos_slot = lay["pos_slot"]
        perm = lambda x: windowing.permute_rows(x, pos_slot).contiguous()
        li = state.inv_inertia
        v6n_p, pos_p, orn_p, imp_out = psweep.solve_substeps_contacts_win(
            perm(_vel_to6(state)), Vec3(*map(perm, state.pos)), Quat(*map(perm, state.orn)),
            perm(state.inv_mass), Sym3(*map(perm, li)), perm(gmask), perm(state.integrable),
            wp["ps_t"], wp["imp_t"], wp["whi2"], wp["wlo2"], wp["scale"], wp["wseg"],
            h, inv_h, lin_scale, ang_scale, sb=SB_WIN, **kw)
        sp = lay["slot_pos"].long()
        state = _vel_from6(state._replace(pos=Vec3(*(t[sp] for t in pos_p)),
                                          orn=Quat(*(t[sp] for t in orn_p))), v6n_p[sp])
        # Impulses back to slot order; wide-overflow rows (sent to the sink) keep their
        # incoming warm-start impulses.
        dest, bp = rw["dest"], rw["bp"]
        imp_rows = torch.where((dest < bp)[:, None],
                               imp_out.T[torch.clamp_max(dest, bp - 1).long(), :8], imc)
        overflow = rw["wide_overflow"]
        wide_demand = rw["wide_demand"].to(torch.int32)
    else:
        # Mass-split valence of Jacobi rows (reference SequentialFallbackBatch.cs:37),
        # maintained incrementally by the store.
        valence = st.jacv[:n_bodies].clamp_min(1.0)
        sa = torch.where(is_jac, valence[st.body_a.long()], 1.0)
        sb_scale = torch.where(is_jac, valence[st.body_b.long()], 1.0)
        M = torch.cat([M, sa[:, None], sb_scale[:, None]], dim=-1)
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
        v6n, pos_n, orn_n, imp_out = psweep.solve_substeps_contacts(
            _vel_to6(state), type(state.pos)(*map(c, state.pos)),
            type(state.orn)(*map(c, state.orn)), c(state.inv_mass),
            type(state.inv_inertia)(*map(c, state.inv_inertia)), gmask, state.integrable,
            Mx[:, :32].T.contiguous(), Mx[:, 32:40].T.contiguous(),
            idx2.to(torch.int32).contiguous(), scale.contiguous(), h, inv_h, lin_scale,
            ang_scale, sb=page, **kw)
        state = _vel_from6(state._replace(pos=pos_n, orn=orn_n), v6n)
        imp_rows = imp_out.T.reshape(P, page, 8)[inv_perm.long()].reshape(B, 8)
        overflow = torch.zeros((), dtype=torch.bool, device=jac_slot.device)
        wide_demand = torch.zeros((), dtype=torch.int32, device=jac_slot.device)

    state = integrate_poses(state, integrator_cfg, h)
    imp_slot = simp0._replace(
        penetration=imp_rows[:, :4],
        tangent=simp0.tangent._replace(x=imp_rows[:, 4], y=imp_rows[:, 5]),
        twist=imp_rows[:, 6],
    )
    demand = torch.stack([jac_slot.sum().to(torch.int32), wide_demand])
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
    """Full substepped solve. The port solves store-only contact scenes through K1 (up to
    8,192 bodies) or K2 (above that, or with ``backend="pallas_win"``), as the JAX
    package's ``solve_all`` picks its kernels, and refuses every other bank shape. The
    JAX package's VMEM and 650k-row feasibility guard is a TPU limit with an XLA path
    behind it; the card has neither, so K2 takes every windowed bank. Returns (state,
    [impulses], {joint impulses}, overflow, [colors], {joint colors}, demand (2,)
    [Jacobi rows, wide rows])."""
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
    use_win = state.pos.x.shape[0] > 8192 or cfg.backend == "pallas_win"
    return _solve_store_fast(state, store_bank, integrator_cfg, cfg, dt, use_win)
