"""Substepped TGS solver: the store fast path over kernels K1 and K2, and the general
(bucketed) path over kernels K3 and K4 (K1 for a contact-only scene with a compound bank,
and for a contact-only scene of the legacy per-frame path).

Counterpart of ``SolveConfig``, ``_solve_store_fast`` and the single-chip bucketed branch
of ``solve_all`` in ``bepuphysics2_tpu/solver/solve.py`` (reference Solver_Solve.cs:1415).
Store-only scenes take the fast path: the slot-order prestep and impulses pack once and
move once into the execution layout, the whole substepped solve runs in one kernel, and a
final pose integration follows. Up to 8,192 bodies the layout is the page-execution order
(pages by color, Jacobi pages last) and the kernel is K1; above that, or with
``backend="pallas_win"``, it is the windowed layout of ``windowing.py`` and the kernel is
K2. Scenes with joints or a compound bank, and any scene with an iteration schedule or a
velocity callback, take the general path (``solve_bucketed``): per step a coloring over
every bank and the color-bucket layout of ``buckets.py``; per substep the depth update,
pose and velocity integration, one warm start of every bank, then per velocity iteration
each contact bank through K3 (the pair store through K4 on the windowed layout) and the
joint bank's color sweep, if any. Without joints, a schedule or a callback the buckets go
through one K1 launch instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bodies import BodyState, KIND_DYNAMIC
from ..collision import pairstore as _ps
from ..collision.pairstore import _compact
from ..constraints import contact as contact_mod
from ..constraints.contact import BodyVel, GatheredInertia
from ..constraints.joints import JOINT_TYPES, JointContext, MultiBodyContext
from ..integrator import IntegratorConfig, integrate_poses, integrate_velocities
from ..ops import sweep as psweep
from ..utils import replay
from ..utils.spring import compute_springiness
from ..utils.vec import Quat, Sym3, Vec3
from . import buckets as bk_mod
from . import windowing

SB_WIN = 256  # rows per windowed slice


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """reference SolveDescription (SolveDescription.cs:17). Fields match the JAX config.
    ``iteration_schedule`` (the reference's VelocityIterationScheduler) is an optional
    tuple of velocity iterations per substep that overrides ``velocity_iterations``."""

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

    def iterations_for(self, substep: int) -> int:
        if self.iteration_schedule is not None:
            return int(self.iteration_schedule[substep])
        return self.velocity_iterations


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


def wave_table(wseg, gid, n_narrow: int, nblk: int, num_colors: int):
    """The wave table of K2 and K4 (``ops.sweep.waves_by_key``) over a windowed bank, from
    ``row_windows``' ``wseg`` and ``gid``, by tensor ops alone (no host sync). A slice of
    the narrow region (the first ``n_narrow`` slices) keys its color ``gid // nblk`` when
    that is below C; every other live slice (narrow Jacobi color C, wide) is a wave of its
    own. The pair store's color claims make each color c < C an independent set over
    dynamic bodies across all Morton blocks, so a wave's slices touch pairwise distinct
    dynamic bodies and the kernels run them at once with the walk's result."""
    n = wseg.shape[0]
    sl = torch.arange(n, device=wseg.device)
    color = torch.div(gid, nblk, rounding_mode="floor").long()
    colored = (sl < n_narrow) & (gid >= 0) & (color < num_colors)
    return psweep.waves_by_key(torch.where(colored, color, -1), wseg[:, 0] >= 0)


def page_wave_table(page_colors, valid, page: int, num_colors: int):
    """The wave table of K1 and K3 over a page stream, by tensor ops alone:
    ``page_colors`` is a list of each bank's per-slice colors in stream order (the store's
    ``page_color`` in execution order; a compound bucket's slice k has color k // (cap /
    page) while that is below C), ``valid`` (B,) bool each row's validity (a slice is live
    when it holds a valid row). A color c < C keys c offset by C per bank, so no wave spans
    two banks; Jacobi and empty slices are waves of their own."""
    C = num_colors
    key = torch.cat([torch.where((c >= 0) & (c < C), c.long() + C * k, -1)
                     for k, c in enumerate(page_colors)])
    return psweep.waves_by_key(key, valid.reshape(-1, page).any(dim=1))


def bucket_page_colors(cap: int, n_rows: int, page: int, num_colors: int, device):
    """Per-slice colors of a compound bucket (``buckets.contact_bucket``): each color's
    capacity ``cap`` is a whole number of pages, so slice k holds color k // (cap / page)
    while that is below C, and the Jacobi rows after them."""
    k = torch.arange(n_rows // page, device=device)
    return torch.div(k, cap // page, rounding_mode="floor").clamp_max(num_colors)


def win_pack(pos, kind, body_a, body_b, valid, color, jacv, M, num_colors: int,
             wide_cap: int):
    """The windowed execution view of one slot-order bank: the body layout, the row
    windows, and K2's bank arguments. ``M`` (B, 40) holds the packed prestep (32) and
    impulse (8) columns; ``jacv`` the store's per-body Jacobi valence. Mass-split rows are
    the Jacobi-colored rows and the wide rows (wide slices mix colors); a body's scale is
    its Jacobi valence plus its wide-row count. Returns a dict with ``lay``, ``rw`` and
    the arguments ``ps_t``, ``imp_t``, ``whi2``, ``wlo2``, ``scale``, ``wseg`` and
    ``waves`` (``wave_table``)."""
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
        waves=wave_table(rw["wseg"], rw["gid"], rw["b_n"] // sb, lay["nblk"], C),
    )


def _damping_scales(integrator_cfg, h):
    """Per-substep linear and angular velocity scales of the integrator's damping."""
    lin = (1.0 - integrator_cfg.linear_damping) ** h if integrator_cfg.linear_damping else 1.0
    ang = (1.0 - integrator_cfg.angular_damping) ** h if integrator_cfg.angular_damping else 1.0
    return lin, ang


def _k_kwargs(integrator_cfg, cfg):
    return dict(n_substeps=cfg.substeps, n_iters=cfg.velocity_iterations,
                angular_mode=integrator_cfg.angular_mode, gravity=integrator_cfg.gravity)


def _k1_solve(state, integrator_cfg, cfg, ps_t, imp_t, idx2, scale, sb: int, h, inv_h, waves):
    """The whole substepped contact solve of one slice stream through K1, with its wave
    table. Returns (state with new poses and velocities, (IMP_ROWS, B) impulses); the
    final pose integration is the caller's."""
    c = lambda t: t.contiguous()
    lin_scale, ang_scale = _damping_scales(integrator_cfg, h)
    gmask = (state.kind == KIND_DYNAMIC) & state.awake
    v6n, pos_n, orn_n, imp_out = psweep.solve_substeps_contacts(
        _vel_to6(state), type(state.pos)(*map(c, state.pos)),
        type(state.orn)(*map(c, state.orn)), c(state.inv_mass),
        type(state.inv_inertia)(*map(c, state.inv_inertia)), gmask, state.integrable, ps_t,
        imp_t, idx2, scale, h, inv_h, lin_scale, ang_scale, sb=sb, waves=waves,
        **_k_kwargs(integrator_cfg, cfg))
    return _vel_from6(state._replace(pos=pos_n, orn=orn_n), v6n), imp_out


def _solve_store_fast(state, store_bank, integrator_cfg, cfg, dt, use_win: bool):
    """Whole-solve fast path for store-only scenes: pack the slot-order prestep and
    impulses into one (B, 40) matrix, move it once into the execution layout, run the
    whole substepped solve in one kernel, and bring the impulses back to slot order.
    ``use_win`` picks the windowed layout and K2 over the page order and K1."""
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

    if use_win:
        lin_scale, ang_scale = _damping_scales(integrator_cfg, h)
        gmask = (state.kind == KIND_DYNAMIC) & state.awake
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
            h, inv_h, lin_scale, ang_scale, sb=SB_WIN, waves=wp["waves"],
            **_k_kwargs(integrator_cfg, cfg))
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
        ps_x = Mx[:, :32].T.contiguous()
        waves = page_wave_table([st.page_color[pp]], ps_x[psweep.PS_VALID] > 0.5, page, C)
        state, imp_out = _k1_solve(state, integrator_cfg, cfg, ps_x, Mx[:, 32:40].T.contiguous(),
                                   idx2.to(torch.int32).contiguous(), scale.contiguous(), page,
                                   h, inv_h, waves)
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


def _ctx14(state: BodyState, world_ii: Sym3) -> torch.Tensor:
    """Packed per-substep body context (NB, 14): pos3 | orn4 | inv_mass | inertia6."""
    return torch.stack([*state.pos, *state.orn, state.inv_mass, *world_ii], -1)


def _inertia_rows(im, scale=None) -> GatheredInertia:
    """(m, 7) inverse-inertia rows (inverse mass, then the symmetric 3 x 3) → a
    GatheredInertia, times ``scale``."""
    if scale is not None:
        im = im * scale[:, None]
    return GatheredInertia(im[:, 0], Sym3(*im[:, 1:].unbind(-1)))


def _split14(rows, scale=None):
    """(m, 14) context rows → (pos, orn, GatheredInertia), inertia times ``scale``."""
    return (Vec3(rows[:, 0], rows[:, 1], rows[:, 2]),
            Quat(rows[:, 3], rows[:, 4], rows[:, 5], rows[:, 6]),
            _inertia_rows(rows[:, 7:14], scale))


def _body_vel(g) -> BodyVel:
    return BodyVel(Vec3(g[:, 0], g[:, 1], g[:, 2]), Vec3(g[:, 3], g[:, 4], g[:, 5]))


def _vel(v6, idx) -> BodyVel:
    """The (NB, 6) velocity rows ``idx`` as a BodyVel."""
    return _body_vel(v6[idx])


def _vel_pair(v6, idx2):
    """Both sides' velocities from one gather of ``idx2`` (the A indices, then the B)."""
    g = v6[idx2]
    m = idx2.shape[0] // 2
    return _body_vel(g[:m]), _body_vel(g[m:])


def _pack_dv(dv: BodyVel) -> torch.Tensor:
    return torch.stack([*dv.linear, *dv.angular], -1)


def _win_store_bucket(state, st, sps, simp, scolor, jrow, cfg, n_bodies: int):
    """The pair store's bucket on the windowed layout (JAX ``solve_all`` :930-976): the
    rows in page-execution order grouped into window slices, scattered into the padded
    (color, Morton block) layout. Mass-split rows are the Jacobi rows and the wide rows,
    scaled by the store's own Jacobi valence plus the wide-row counts (not the general
    path's global valence, which also counts the joints' Jacobi rows: the JAX formula,
    ROADMAP queue 3)."""
    C = cfg.num_colors
    sb = SB_WIN
    if st.capacity % sb:
        raise ValueError(f"the windowed layout runs slices of {sb} rows: the pair store's "
                         f"capacity {st.capacity} (max_pairs rounded to pages) is not a "
                         f"multiple of {sb}")
    a_s, b_s = sps.body_a, sps.body_b
    wide_cap = max(sb, _round_up(cfg.wide_cap_rows or st.capacity // 8, sb))
    lay = windowing.body_layout(state.pos, state.kind)
    rw = windowing.row_windows(lay, a_s, b_s, sps.valid, scolor, C, sb, wide_cap)
    dest, bp = rw["dest"], rw["bp"]
    wct = _wide_counts(rw["wide"], a_s, b_s, n_bodies, wide_cap)
    sval = torch.clamp_min(st.jacv[:n_bodies] + wct[:n_bodies], 1.0)
    split_row = jrow | rw["wide"]
    sa = torch.where(split_row, sval[a_s.long()], 1.0)
    sbs = torch.where(split_row, sval[b_s.long()], 1.0)
    scat = lambda x, fill=0: windowing.scatter_rows(dest, bp, x, fill)
    tree = lambda f, t: f(t) if torch.is_tensor(t) else type(t)(*(tree(f, x) for x in t))
    saw, sbw = scat(sa, 1), scat(sbs, 1)
    rel_a, rel_b = scat(rw["rel_a"]), scat(rw["rel_b"])
    present = scat(torch.ones_like(sps.valid))
    idx2 = torch.cat([scat(a_s), scat(b_s)]).long()
    L = psweep.L
    div = lambda x: torch.div(x, L, rounding_mode="floor")
    whi2 = bk_mod.slice_major(div(rel_a), div(rel_b), sb).to(torch.int32)
    wlo2 = bk_mod.slice_major(torch.remainder(rel_a, L), torch.remainder(rel_b, L),
                              sb).to(torch.int32)
    wseg = rw["wseg"].contiguous()
    ps_w = tree(scat, sps)
    # K4's writing entries: valid rows' sides on bodies with inertia (what K4 finds from
    # the streamed inertia, each slot's own times its scale), first in its sums' order.
    still = psweep.body_still(state.inv_mass, state.inv_inertia)
    writes = bk_mod.slice_major(ps_w.valid & ~still[idx2[:bp]], ps_w.valid & ~still[idx2[bp:]],
                                sb).reshape(-1, 2 * sb)
    return dict(
        ps=ps_w, imp=tree(scat, simp), idx2=idx2, s2=torch.cat([saw, sbw]),
        tgt2=torch.where(torch.cat([present, present]), idx2, n_bodies),
        lay=lay, dest=dest, bp=bp, imp_orig=simp, whi2=whi2, wlo2=wlo2,
        wscale=bk_mod.slice_major(saw, sbw, sb), wseg=wseg,
        worder=psweep.writer_order(psweep.window_positions(whi2, wlo2, wseg, sb), writes),
        waves=wave_table(wseg, rw["gid"], rw["b_n"] // sb, lay["nblk"], C),
        overflow=rw["wide_overflow"], wide_demand=rw["wide_demand"].to(torch.int32))


def _whole_solve_ok(integrator_cfg, cfg) -> bool:
    """Whether the whole-solve kernels (K1, K2) may take a contact-only scene: they run
    the default gravity and damping and a fixed iteration count in every substep, so an
    iteration schedule or a velocity callback takes the scene off them, as in the JAX
    package."""
    return cfg.iteration_schedule is None and integrator_cfg.velocity_callback is None


def legacy_slice(contact_banks, cfg) -> int:
    """The slice size of the contact banks when there is no pair store (JAX ``solve_all``
    :646-649): ``min(512, round_up(max color capacity, 128))``, the capacity of a color
    being ``ceil(color_cap_factor * rows / C)``."""
    caps = [max(1, -(-int(cfg.color_cap_factor * cb[0].body_a.shape[0]) // cfg.num_colors))
            for cb in contact_banks]
    return min(512, _round_up(max(caps + [1]), 128))


def solve_bucketed(state, contact_banks, joint_banks: dict, integrator_cfg, cfg, dt,
                   store_bank: dict, base_used, use_win: bool = False):
    """The general solve for scenes with joints or a compound bank beside the pair store,
    or with an iteration schedule or a velocity callback, and for every scene of the
    legacy per-frame path (``store_bank`` None: its contact banks colored with their
    carried colors and bucketed in slices of ``legacy_slice``): the JAX package's bucketed
    ``substep_bucketed`` loop in its Pallas form. Up to 8,192 bodies every contact bank
    goes through K3 (one launch per bank per velocity iteration per substep; a lone
    contact bank, as JAX runs it, one launch per substep carrying that substep's
    iterations); on the windowed layout (``use_win``: no compound bank) the store goes
    through K4 instead. A contact-only scene (no joints) without a schedule or a callback
    takes the JAX package's whole-solve branch: one K1 launch over the concatenated
    banks. Above 8,192 bodies the JAX package solves a legacy scene on its XLA bucketed
    path, because its kernels route bodies through one-hot products whose cost grows with
    the body count; the card's kernels index bodies directly, so the same K1 and K3 routes
    serve at every size. Returns as ``solve_all``."""
    h, inv_h = substep_scalars(dt, cfg.substeps)
    C = cfg.num_colors
    n_bodies = state.pos.x.shape[0]
    dev = state.kind.device
    # Two-body (and one-body) types first, one segment of the coloring table; the
    # multi-body types after them, uncapped (JAX solve.py:503-512).
    tb_names = sorted(n for n in joint_banks if getattr(JOINT_TYPES[n], "N_BODIES", 2) <= 2)
    mb_names = sorted(n for n in joint_banks if getattr(JOINT_TYPES[n], "N_BODIES", 2) > 2)
    contact_banks = [(cb[0], cb[1], cb[2] if len(cb) > 2 and cb[2] is not None else
                      torch.full((cb[0].body_a.shape[0],), -1, dtype=torch.int32, device=dev))
                     for cb in contact_banks]

    tree = lambda f, t: f(t) if torch.is_tensor(t) else type(t)(*(tree(f, x) for x in t))
    st = store_bank["store"] if store_bank is not None else None
    if st is not None:
        # The pair store in page-execution order (pages by color, Jacobi pages last).
        page = st.page
        perm_pages, is_jac_pages, inv_perm = _ps.exec_order(st, C)
        pp, ip = perm_pages.long(), inv_perm.long()
        pg = lambda x: x.reshape((st.n_pages, page) + x.shape[1:])[pp].reshape(x.shape)
        ipg = lambda x: x.reshape((st.n_pages, page) + x.shape[1:])[ip].reshape(x.shape)
        sps = tree(pg, store_bank["ps"])
        jrow = is_jac_pages.repeat_interleave(page)
    else:
        page = legacy_slice(contact_banks, cfg)

    table = bk_mod.color_table(state, contact_banks, joint_banks, tb_names, mb_names, cfg, page,
                               base_used)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    jac_demand = torch.zeros((), dtype=torch.int32, device=dev)
    wide_demand = torch.zeros((), dtype=torch.int32, device=dev)
    buckets = []
    in_jacobi = []
    for (ps, im, _), col, rnk, cap in zip(contact_banks, table["ccolors"], table["cranks"],
                                          table["caps"]):
        b = bk_mod.contact_bucket(ps, im, col, rnk, cap, page, cfg.jacobi_cap_factor, C)
        overflow = overflow | b["spill"]
        jac_demand = torch.maximum(jac_demand, b["jac_n"])
        in_jacobi.append(b["kept_j"])
        buckets.append(b)
    ju = None
    if tb_names:
        ju = bk_mod.joint_bucket(joint_banks, tb_names, table, cfg.jacobi_cap_factor, C)
        overflow = overflow | ju["spill"]
        jac_demand = torch.maximum(jac_demand, ju["jac_n"])
    for name in tb_names + mb_names:
        in_jacobi.append(table["bank_valid"][name] & (table["jcolors"][name] == C))
    valence = bk_mod.valence(table, in_jacobi, n_bodies, None if st is None else st.jacv)

    # The store bucket: page order with Jacobi pages mass-split by the global valence, or
    # the windowed layout (its own split scales, K4).
    n_store = int(st is not None)
    if st is not None:
        jac_demand = torch.maximum(jac_demand, (jrow & sps.valid).sum().to(torch.int32))
        v = lambda t: sps.valid.reshape((-1,) + (1,) * (t.dim() - 1))
        simp = tree(lambda x: torch.where(v(x), x, 0.0), tree(pg, store_bank["imp"]))
    if use_win:
        win = _win_store_bucket(state, st, sps, simp, pg(st.color), jrow, cfg, n_bodies)
        overflow = overflow | win["overflow"]
        wide_demand = win["wide_demand"]
        buckets.insert(0, win)
    else:
        if st is not None:
            buckets.insert(0, dict(ps=sps, imp=simp, is_j=jrow))
        for b in buckets[n_store:]:
            b["is_j"] = torch.arange(b["ps"].body_a.shape[0], device=dev) >= C * b["cap"]
    for b in buckets:
        if not use_win:
            ba, bb = b["ps"].body_a.long(), b["ps"].body_b.long()
            b["sa"] = torch.where(b["is_j"], valence[ba], 1.0)
            b["sb"] = torch.where(b["is_j"], valence[bb], 1.0)
            b["idx2"] = b["tgt2"] = torch.cat([ba, bb])
            b["s2"] = torch.cat([b["sa"], b["sb"]])
            b["k_idx2"] = bk_mod.slice_major(b["ps"].body_a, b["ps"].body_b, page).to(torch.int32)
            b["k_scale"] = bk_mod.slice_major(b["sa"], b["sb"], page)
            b["k_sb"] = page
        b["spring"] = compute_springiness(b["ps"].spring, h)
    whole = ju is None and not mb_names and _whole_solve_ok(integrator_cfg, cfg)
    if not whole and not use_win:
        # K3's tables, once per step: each bank's waves over its own page colors, and its
        # sums' order, writing entries (valid rows' sides on bodies with inertia) first.
        still = psweep.body_still(state.inv_mass, state.inv_inertia)
        for k, b in enumerate(buckets):
            valid, idx = b["ps"].valid, b["k_idx2"].view(-1, 2 * page)
            colors = (st.page_color[pp] if k < n_store else bucket_page_colors(
                b["cap"], valid.shape[0], page, C, dev))
            b["k_waves"] = page_wave_table([colors], valid, page, C)
            writes = bk_mod.slice_major(valid, valid, page).view(-1, 2 * page) & ~still[idx.long()]
            b["k_order"] = psweep.writer_order(idx, writes)

    if whole:
        # Contact-only: the JAX package's whole-solve branch (solve.py:1785-1856), one K1
        # launch over the store pages and then each compound bucket, slices of the page.
        # The wave keys: the store's page colors in execution order, then each bucket's.
        pack = lambda f: torch.cat([f(b) for b in buckets], 1).contiguous()
        ps_k = pack(lambda b: psweep.pack_contact_prestep_cols(b["ps"], b["spring"]).T)
        colors = [st.page_color[pp] for _ in range(n_store)] + [
            bucket_page_colors(b["cap"], b["ps"].body_a.shape[0], page, C, dev)
            for b in buckets[n_store:]]
        state, imp_out = _k1_solve(
            state, integrator_cfg, cfg, ps_k,
            pack(lambda b: psweep.pack_contact_impulses_cols(b["imp"]).T),
            torch.cat([b["k_idx2"] for b in buckets]).contiguous(),
            torch.cat([b["k_scale"] for b in buckets]).contiguous(), page, h, inv_h,
            page_wave_table(colors, ps_k[psweep.PS_VALID] > 0.5, page, C))
        imps, off = [], 0
        for b in buckets:
            n = b["ps"].body_a.shape[0]
            imps.append(_unpack_impulses(imp_out[:, off:off + n], b["imp"]))
            off += n
        joint_imps = {}
    else:
        mb = _multibody_banks(joint_banks, mb_names, table, C)
        state, imps, ju_imp, mb_imps = _substep_loop(state, buckets, ju, tb_names, mb, valence,
                                                     integrator_cfg, cfg, h, inv_h, n_bodies)
        joint_imps = dict(mb_imps)
        if ju is not None:
            BU = ju["present"].shape[0]
            u = torch.where((ju["pos"] < BU)[:, None],
                            ju_imp[torch.clamp_max(ju["pos"], BU - 1).long()], 0.0)
            off = 0
            for name in tb_names:
                m = joint_banks[name]["bodies"].shape[0]
                joint_imps[name] = u[off:off + m, :JOINT_TYPES[name].N_IMPULSE]
                off += m
    state = integrate_poses(state, integrator_cfg, h)

    # Impulses back to their banks' order: the store to slot order (from the windowed
    # layout through ``dest``, where wide-overflow rows keep their incoming impulses), the
    # others through each row's bucket position (rows left out keep theirs).
    if use_win:
        w = buckets[0]
        placed = w["dest"] < w["bp"]
        dc = torch.clamp_max(w["dest"], w["bp"] - 1).long()
        back = lambda new, old: torch.where(
            placed.reshape((-1,) + (1,) * (old.dim() - 1)), new[dc], old)
        imps_out = [tree(ipg, _map_impulses(back, imps[0], w["imp_orig"]))]
    else:
        imps_out = [tree(ipg, imps[0]) for _ in range(n_store)]
    for b, (_, im0, _), im in zip(buckets[n_store:], contact_banks, imps[n_store:]):
        B = b["ps"].body_a.shape[0]
        inb = b["pos"] < B
        pc = torch.clamp_max(b["pos"], B - 1).long()
        keep = lambda new, old: torch.where(inb.reshape((-1,) + (1,) * (old.dim() - 1)), new[pc], old)
        imps_out.append(_map_impulses(keep, im, im0))
    demand = torch.stack([jac_demand, wide_demand])
    return (state, imps_out, joint_imps, overflow, table["persist_c"], table["persist_j"],
            demand)


def _map_impulses(f, new, old):
    """ContactImpulses of ``f(new_leaf, old_leaf)``, leaf by leaf."""
    return type(old)(f(new.penetration, old.penetration),
                     type(old.tangent)(*map(f, new.tangent, old.tangent)),
                     f(new.twist, old.twist))


def _multibody_banks(joint_banks, mb_names, table, C: int):
    """The three- and four-body banks as the substep loop runs them (JAX ``solve_all``
    :1238-1263): each whole bank masked per color, after the unified joint sweep. Per
    bank its class, body columns, prestep, liveness, colors and impulses (zero where the
    record is not live, so that warm starts skip it)."""
    out = []
    for name in mb_names:
        bank, cls = joint_banks[name], JOINT_TYPES[name]
        live = table["bank_valid"][name]
        out.append(dict(name=name, cls=cls, ps=bank["prestep"], live=live,
                        color=table["jcolors"][name],
                        idx=[bank["bodies"][:, j].long() for j in range(cls.N_BODIES)],
                        imp=bank["impulse"] * live[:, None].float()))
    return out


def _substep_loop(state, buckets, ju, tb_names, mb, valence, integrator_cfg, cfg, h, inv_h,
                  n_bodies: int):
    """Every substep of the general path (JAX ``substep_bucketed``): the depth update, pose
    and velocity integration, one warm start of every bank, then per velocity iteration
    (``cfg.iterations_for`` the substep) each contact bank through its kernel (K3, or K4
    for the windowed store bucket), the joint bank's color sweep, where there is a joint
    bank (``ju`` is None without one), and the multi-body banks' passes (``mb``, from
    ``_multibody_banks``). A lone contact bank on the page layout runs a substep's
    iterations in one K3 launch, as the JAX package runs them in one kernel call (JAX
    ``solve.py:1652-1654``). Returns (state, bucket-order impulses, joint impulses or None,
    the multi-body banks' impulses by name)."""
    C = cfg.num_colors
    dev = state.kind.device
    sink = n_bodies
    warm_tgt = [b["tgt2"] for b in buckets]
    if ju is not None:
        # Joint bank: per-color gathers, and fixed-order sums for the Jacobi slice.
        cap_u, ncap = ju["cap"], ju["ncap"]
        ja, jb = ju["a"].long(), ju["b"].long()
        ju["idx2"] = torch.cat([ja, jb])
        pres2 = torch.cat([ju["present"], ju["present"]])
        ju["idx2_col"] = [torch.cat([ja[c * cap_u:(c + 1) * cap_u],
                                     jb[c * cap_u:(c + 1) * cap_u]]) for c in range(C)]
        ju["tgt_col"] = [torch.where(
            pres2.reshape(2, -1)[:, c * cap_u:(c + 1) * cap_u].reshape(-1), ju["idx2_col"][c],
            sink) for c in range(C)]
        ju["idx2_j"] = torch.cat([ja[ncap:], jb[ncap:]])
        pj = torch.cat([ju["present"][ncap:], ju["present"][ncap:]])
        ju["s2_j"] = torch.cat([valence[ja[ncap:]], valence[jb[ncap:]]])
        ju["sum_j"] = bk_mod.FixedOrderSum(torch.where(pj, ju["idx2_j"], sink), n_bodies)
        warm_tgt.append(torch.where(pres2, ju["idx2"], sink))
        ju_data = {k: ju[k] for k in ("ps", "tag", "live", "idx2_col", "tgt_col", "idx2_j",
                                      "s2_j")}
        ju_data["sum_j"] = ju["sum_j"].tensors()
        ju_key = ("joint sweep", C, cap_u, ncap, n_bodies, tuple(tb_names), h, inv_h)
    for b in mb:
        # Warm starts after the unified bank's; the Jacobi pass sums its rows in fixed order.
        warm_tgt += [torch.where(b["live"], i, sink) for i in b["idx"]]
        b["jac"] = b["live"] & (b["color"] == C)
        b["s"] = [valence[i] for i in b["idx"]]
    if mb:
        mb_sum = bk_mod.FixedOrderSum(torch.cat(
            [torch.where(b["jac"], i, sink) for b in mb for i in b["idx"]]), n_bodies)
    warm_sum = bk_mod.FixedOrderSum(torch.cat(warm_tgt), n_bodies)

    def mb_ctx(table14, v6, b, active, jacobi: bool):
        rows = [table14[i] for i in b["idx"]]
        return MultiBodyContext(
            pos=[Vec3(r[:, 0], r[:, 1], r[:, 2]) for r in rows],
            vel=[BodyVel(Vec3(g[:, 0], g[:, 1], g[:, 2]), Vec3(g[:, 3], g[:, 4], g[:, 5]))
                 for g in (v6[i] for i in b["idx"])],
            inv_mass=[r[:, 7] * s if jacobi else r[:, 7] for r, s in zip(rows, b["s"])],
            active=active)

    def mb_tail(table14, v6, imps):
        """One iteration of the multi-body banks (JAX ``mb_iteration_tail``): per color a
        masked pass over every bank (within a color no two live rows share a dynamic body,
        so the deltas add in any order), then the Jacobi pass, mass-split by the valence."""
        imps = dict(imps)
        for c in range(C):
            tgt, vals = [], []
            for b in mb:
                new, dvs = b["cls"].solve(b["ps"], imps[b["name"]],
                                          mb_ctx(table14, v6, b, b["live"] & (b["color"] == c),
                                                 False), h, inv_h)
                imps[b["name"]] = new
                tgt += b["idx"]
                vals += [_pack_dv(d) for d in dvs[:len(b["idx"])]]
            v6 = v6.index_add(0, torch.cat(tgt), torch.cat(vals))
        vals = []
        for b in mb:
            new, dvs = b["cls"].solve(b["ps"], imps[b["name"]],
                                      mb_ctx(table14, v6, b, b["jac"], True), h, inv_h)
            imps[b["name"]] = new
            vals += [_pack_dv(d) * (1.0 / s)[:, None] for d, s in zip(dvs, b["s"])]
        return mb_sum.add(v6, torch.cat(vals)), imps

    def ju_ctx(table14, v6, idx2, active, scale2=None):
        rows = table14[idx2]
        m = idx2.shape[0] // 2
        pos_a, orn_a, gi_a = _split14(rows[:m], None if scale2 is None else scale2[:m])
        pos_b, orn_b, gi_b = _split14(rows[m:], None if scale2 is None else scale2[m:])
        va, vb = _vel_pair(v6, idx2)
        return JointContext(pos_a=pos_a, orn_a=orn_a, inertia_a=gi_a, vel_a=va, pos_b=pos_b,
                            orn_b=orn_b, inertia_b=gi_b, vel_b=vb, active=active)

    def ju_apply(fn_name, ps, imp, tag, ctx, names):
        """The solve / warm start of each type in ``names`` masked by the row tag, merged.
        Returns the impulses and the (2n, 6) velocity deltas, the A sides then the B
        sides."""
        n = tag.shape[0]
        d12 = torch.zeros((n, 12), dtype=torch.float32, device=dev)
        new_imp = imp
        for name in names:
            cls = JOINT_TYPES[name]
            m_t = ctx.active & (tag == ju["type_ids"][name])
            ctx_t = ctx._replace(active=m_t)
            ps_t, imp_t = ps[:, :cls.N_PRESTEP], new_imp[:, :cls.N_IMPULSE]
            if fn_name == "solve":
                imp_out, da, db = cls.solve(ps_t, imp_t, ctx_t, h, inv_h)
                new_imp = torch.where(m_t[:, None], bk_mod.pad_cols(imp_out, bk_mod.U_IMPULSE),
                                      new_imp)
            else:
                da, db = cls.warm_start(ps_t, imp_t, ctx_t)
            d = torch.stack([*da.linear, *da.angular, *db.linear, *db.angular], -1)
            d12 = d12 + torch.where(m_t[:, None], d, 0.0)
        return new_imp, torch.cat([d12[:, :6], d12[:, 6:]])

    def ju_color_sweep(d):
        """One Gauss-Seidel sweep over the unified joint bank, from the iteration's
        ``table14``, ``v6`` and impulses ``imp`` in ``d`` and the step's bank (``ju_data``).
        Within a color no two live rows share a dynamic body, and rows of other bodies
        carry exact zeros, so each color's deltas add with ``index_add`` in any order; the
        Jacobi slice sums in fixed order. On the card it runs as one replayed graph
        (``utils/replay.py``): every type on every pass is hundreds of small kernels."""
        table14, imp = d["table14"], d["imp"]
        ext = torch.cat([d["v6"], d["v6"][:1]])
        for c in range(C):
            cs = slice(c * cap_u, (c + 1) * cap_u)
            ctx = ju_ctx(table14, ext[:n_bodies], d["idx2_col"][c], d["live"][cs])
            new_imp, p2 = ju_apply("solve", d["ps"][cs], imp[cs], d["tag"][cs], ctx, tb_names)
            ext = ext.index_add(0, d["tgt_col"][c], p2)
            imp = torch.cat([imp[:c * cap_u], new_imp, imp[(c + 1) * cap_u:]])
        v6 = ext[:n_bodies]
        ctx_j = ju_ctx(table14, v6, d["idx2_j"], d["live"][ncap:], d["s2_j"])
        new_imp, p2 = ju_apply("solve", d["ps"][ncap:], imp[ncap:], d["tag"][ncap:], ctx_j,
                               tb_names)
        sum_j = bk_mod.FixedOrderSum.of(d["sum_j"], n_bodies)
        return sum_j.add(v6, p2 / d["s2_j"][:, None]), torch.cat([imp[:ncap], new_imp])

    def sweep_bank(b, v6, ps_t, it_t, imp_t, n_iters=1):
        """``n_iters`` velocity iterations of one contact bank through its kernel (K4: one)."""
        if "wseg" not in b:
            return psweep.contact_sweep(v6.contiguous(), it_t, ps_t, imp_t, b["k_idx2"],
                                        b["k_scale"], inv_h, sb=b["k_sb"], n_iters=n_iters,
                                        order=b["k_order"], waves=b["k_waves"])
        pos_slot, slot_pos = b["lay"]["pos_slot"], b["lay"]["slot_pos"].long()
        v6p, imp_t = psweep.contact_sweep_win(
            windowing.permute_rows(v6, pos_slot).contiguous(), it_t, ps_t, imp_t, b["whi2"],
            b["wlo2"], b["wscale"], b["wseg"], inv_h, sb=SB_WIN, n_iters=1,
            order=b["worder"], waves=b["waves"])
        return v6p[slot_pos], imp_t

    presteps = [b["ps"] for b in buckets]
    imps = [b["imp"] for b in buckets]
    ju_imp = None if ju is None else ju["imp0"]
    mb_imps = {b["name"]: b["imp"] for b in mb}
    lone = ju is None and not mb and len(buckets) == 1 and "wseg" not in buckets[0]
    for s in range(cfg.substeps):
        if s > 0:
            v6 = torch.stack([*state.vel, *state.omega], -1)
            presteps = [contact_mod.incremental_depth_update(ps, *_vel_pair(v6, b["idx2"]), h)
                        for ps, b in zip(presteps, buckets)]
            state = integrate_poses(state, integrator_cfg, h)
        state = integrate_velocities(state, integrator_cfg, h)
        table14 = _ctx14(state, state.world_inv_inertia())
        v6 = torch.stack([*state.vel, *state.omega], -1)

        # Warm start: velocity-independent deltas of every bank, summed in fixed order.
        # The windowed bank streams its mass-split inertia rows to K4 as well.
        p2s, g2s = [], []
        for ps, im, b in zip(presteps, imps, buckets):
            n = b["idx2"].shape[0] // 2
            g2 = table14[b["idx2"]][:, 7:14] * b["s2"][:, None]
            g2s.append(g2)
            ia = GatheredInertia(g2[:n, 0], Sym3(*g2[:n, 1:].unbind(-1)))
            ib = GatheredInertia(g2[n:, 0], Sym3(*g2[n:, 1:].unbind(-1)))
            z = Vec3.zeros(n, device=dev)
            dva, dvb = contact_mod.warm_start(ps, im, ia, ib, BodyVel(z, z), BodyVel(z, z))
            p2s.append(torch.cat([_pack_dv(dva), _pack_dv(dvb)]) / b["s2"][:, None])
        if ju is not None:
            ctx_w = ju_ctx(table14, v6, ju["idx2"], ju["live"])
            p2s.append(ju_apply("warm", ju["ps"], ju_imp, ju["tag"], ctx_w, tb_names)[1])
        for b in mb:
            dvs = b["cls"].warm_start(b["ps"], mb_imps[b["name"]],
                                      mb_ctx(table14, v6, b, b["live"], False))
            p2s += [_pack_dv(d) for d in dvs[:len(b["idx"])]]
        v6 = v6 + warm_sum.add(torch.zeros_like(v6), torch.cat(p2s))

        # Velocity iterations: each contact bank through its kernel, then the joint sweep.
        ps_ts = [psweep.pack_contact_prestep_cols(ps, b["spring"]).T.contiguous()
                 for ps, b in zip(presteps, buckets)]
        inertia7 = table14[:, 7:14].contiguous()
        it_ts = [psweep.pack_inertia_rows(g2[:g2.shape[0] // 2], g2[g2.shape[0] // 2:])
                 if "wseg" in b else inertia7 for g2, b in zip(g2s, buckets)]
        n_iters = cfg.iterations_for(s)
        for _ in range(1 if lone and n_iters else n_iters):
            for ci, b in enumerate(buckets):
                imp_t = psweep.pack_contact_impulses_cols(imps[ci]).T.contiguous()
                v6, imp_t = sweep_bank(b, v6, ps_ts[ci], it_ts[ci], imp_t,
                                       n_iters if lone else 1)
                imps[ci] = _unpack_impulses(imp_t, imps[ci])
            if ju is not None:
                v6, ju_imp = replay.run(ju_key, ju_color_sweep,
                                        dict(ju_data, table14=table14, v6=v6, imp=ju_imp))
            if mb:
                v6, mb_imps = mb_tail(table14, v6, mb_imps)
        state = _vel_from6(state, v6)
    return state, imps, ju_imp, mb_imps


def _unpack_impulses(imp_t, like):
    return like._replace(penetration=imp_t[:4].T, tangent=like.tangent._replace(
        x=imp_t[4], y=imp_t[5]), twist=imp_t[6])


def solve_all(
    state: BodyState,
    contact_banks,
    joint_banks: dict,
    integrator_cfg: IntegratorConfig,
    cfg: SolveConfig,
    dt,
    group=None,
    store_bank: dict = None,
    base_used=None,
):
    """Full substepped solve, picking its kernels as the JAX package's ``solve_all`` picks
    them. Store-only scenes solve through K1 (up to 8,192 bodies) or K2 (above that, or
    with ``backend="pallas_win"``). Scenes with joints take the general path over K3, or
    over K4 on the windowed layout; a contact-only scene with a compound bank, or any
    contact-only scene of the legacy per-frame path (``store_bank`` None), takes one K1
    launch over the concatenated banks. ``group`` (JAX ``axis_name``), a
    ``torch.distributed`` process group: the banks are this rank's shards, and the solve is
    the masked one of ``masked.py``, in plain PyTorch ops (no kernel, in either package). An iteration schedule or a velocity callback
    takes every scene off the whole-solve kernels K1 and K2 (JAX ``solve.py:583-584``,
    ``:1792-1793``): it runs the general path's substep loop, K3 up to 8,192 bodies and K4
    on the windowed layout. The JAX package's VMEM and 650k-row feasibility
    guard is a TPU limit with an XLA path behind it; the card has neither, so the windowed
    kernels take every windowed bank. Every other bank shape is refused by name. Returns
    (state, [impulses], {joint impulses}, overflow, [colors], {joint colors}, demand (2,)
    [Jacobi rows, wide rows])."""
    if group is not None:
        if store_bank is not None:
            raise ValueError("store banks are single-device; use the masked sharded path")
        from .masked import solve_masked

        return solve_masked(state, contact_banks, joint_banks, integrator_cfg, cfg, dt, group)
    use_win = store_bank is not None and (state.pos.x.shape[0] > 8192
                                          or cfg.backend == "pallas_win")
    if (store_bank is not None and not joint_banks and not contact_banks
            and _whole_solve_ok(integrator_cfg, cfg)):
        return _solve_store_fast(state, store_bank, integrator_cfg, cfg, dt, use_win)
    if use_win and contact_banks:
        raise NotImplementedError(
            "a compound bank on the windowed layout (above 8,192 bodies or "
            "backend='pallas_win') is not solved: the JAX package's windowed general path "
            "fails on it (solver/solve.py:1601 sets tt = None, :1638 passes it to "
            "contact_sweep, ops/sweep.py:416 reads tt.shape), so the port has no reference "
            "to hold it to (ROADMAP queue 3)")
    return solve_bucketed(state, contact_banks, joint_banks, integrator_cfg, cfg, dt,
                          store_bank, base_used, use_win)
