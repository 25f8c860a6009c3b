"""The constraint-sharded solve: masked full-bank color passes whose velocity deltas sum
over a process group.

Counterpart of the branch of ``solve_all`` in ``bepuphysics2_tpu/solver/solve.py`` that
runs when ``axis_name`` is set (``bucketed = False``, :525): ``gather_global`` (:611),
the coloring and the rank's slice of it (:700-737), the masked helpers (:1138-1295) and
``substep_masked`` (:1686-1770). The bodies are replicated on every rank and each
constraint bank is this rank's shard of its slot axis; ``group`` is the
``torch.distributed`` process group that stands for the JAX mesh axis.

- The coloring runs over the all-gathered global constraint table, the same on every
  rank, and each rank takes its own slice of the colors.
- A color pass accumulates this rank's (NB, 6) velocity delta and applies the
  ``all_reduce(SUM)`` of it (JAX ``apply_dv``'s ``psum``). Within a color no two
  constraints on any rank share a dynamic body, so the sum is the single-device
  Gauss-Seidel update, bit for bit.
- The warm start and the Jacobi pass sum rows that share bodies. The JAX package sums
  them per shard and then across shards (``psum``), so its result depends on how the rows
  are cut; the port gathers the rows (``all_gather``) into the single-device order and
  sums them there in a fixed order (``buckets.FixedOrderSum``), so the step gives the
  same bits at every world size.
- Per substep: the depth update and pose integration, velocity integration, one warm
  start of every bank, then per velocity iteration one pass per color over every contact
  and joint bank and the Jacobi pass, mass-split by the global valence.

The JAX package runs this path in XLA ops and reaches no Pallas kernel; the port runs it
in plain PyTorch ops and reaches no kernel either.
"""
from __future__ import annotations

import torch

from ..bodies import KIND_DYNAMIC
from ..constraints import contact as contact_mod
from ..constraints.contact import BodyVel
from ..constraints.joints import JOINT_TYPES, ONE_BODY_NAMES, JointContext, MultiBodyContext
from ..integrator import integrate_poses, integrate_velocities
from ..parallel import comm
from ..utils.vec import Vec3
from . import buckets as bk_mod
from .coloring import color_constraints_incremental, jacobi_valence_kary
from .solve import _inertia_rows, _pack_dv, _vel, _vel_pair, substep_scalars

I32 = torch.int32


def _delta(new: BodyVel, old: BodyVel) -> torch.Tensor:
    return _pack_dv(BodyVel(new.linear - old.linear, new.angular - old.angular))


def solve_masked(state, contact_banks, joint_banks: dict, integrator_cfg, cfg, dt, group):
    """The sharded ``solve_all``: see the module note. ``contact_banks`` are this rank's
    (prestep, impulses[, carried colors]) shards and ``joint_banks`` its joint bank
    shards (with ``impulse`` and ``color``); every rank must hold shards of the same
    sizes. Returns as ``solve_all``: (state, [impulses], {joint impulses}, overflow
    (False: nothing is bucketed), [colors], {joint colors}, demand (2,) [this rank's
    Jacobi rows, 0])."""
    h, inv_h = substep_scalars(dt, cfg.substeps)
    C = cfg.num_colors
    n_bodies = state.pos.x.shape[0]
    dev = state.kind.device
    me = comm.rank(group)
    tb_names = sorted(n for n in joint_banks if getattr(JOINT_TYPES[n], "N_BODIES", 2) <= 2)
    mb_names = sorted(n for n in joint_banks if getattr(JOINT_TYPES[n], "N_BODIES", 2) > 2)
    names = tb_names + mb_names
    cbanks = [(cb[0], cb[1], cb[2] if len(cb) > 2 and cb[2] is not None else
               torch.full((cb[0].body_a.shape[0],), -1, dtype=I32, device=dev))
              for cb in contact_banks]

    # The global constraint table: every rank's shard of every group, gathered.
    arity = max([2] + [JOINT_TYPES[n].N_BODIES for n in mb_names])
    dyn_of = lambda c: state.kind[c.long()] == KIND_DYNAMIC
    bank_valid = {n: bk_mod.bank_live(state.awake, joint_banks[n], n) for n in names}
    groups = [([ps.body_a, ps.body_b], ps.valid, prev) for ps, _, prev in cbanks]
    for n in names:
        bank = joint_banks[n]
        nb = 1 if n in ONE_BODY_NAMES else getattr(JOINT_TYPES[n], "N_BODIES", 2)
        groups.append(([bank["bodies"][:, j] for j in range(nb)], bank_valid[n],
                       bank.get("color", torch.full((bank["bodies"].shape[0],), -1,
                                                    dtype=I32, device=dev))))

    world = comm.world_size(group)

    def gather(x, sizes):
        """(L, ...) rows of this rank, in segments of ``sizes`` rows → every rank's rows,
        segment by segment (rank 0's segment k, rank 1's, ..., then segment k + 1): for a
        constraint group, the JAX package's all-gathered bank in slot order."""
        g = comm.all_gather(x, group).reshape((world, x.shape[0]) + tuple(x.shape[1:]))
        out, off = [], 0
        for size in sizes:
            out.append(g[:, off:off + size].reshape((world * size,) + tuple(x.shape[1:])))
            off += size
        return torch.cat(out)

    def table(cols):
        zero = torch.zeros_like(cols[0])
        pad = arity - len(cols)
        dyn = [dyn_of(c).to(I32) for c in cols]
        return torch.stack(cols + [zero] * pad + dyn + [torch.zeros_like(dyn[0])] * pad, -1)

    # One gather of every group's table columns, validity and carried colors.
    sizes = [v.shape[0] for _, v, _ in groups]
    rows = gather(torch.cat([torch.cat([table(cols), v[:, None].to(I32), p[:, None].to(I32)],
                                       -1) for cols, v, p in groups]).to(I32), sizes)
    all_refs, all_dyn = rows[:, :arity].contiguous(), rows[:, arity:2 * arity] > 0
    all_color, _ = color_constraints_incremental(
        all_refs, all_dyn, rows[:, 2 * arity] > 0, rows[:, 2 * arity + 1].contiguous(),
        n_bodies, C, rounds=cfg.color_rounds, churn_cap=cfg.color_churn_cap)
    colors, off = [], 0
    for m in sizes:
        colors.append(all_color[off + me * m: off + (me + 1) * m])
        off += world * m
    ccolors = colors[:len(cbanks)]
    jcolors = dict(zip(names, colors[len(cbanks):]))
    persist_c = [torch.where(ps.valid & (c < C), c, -1).to(I32)
                 for (ps, _, _), c in zip(cbanks, ccolors)]
    persist_j = {n: torch.where(bank_valid[n] & (jcolors[n] < C), jcolors[n], -1).to(I32)
                 for n in names}
    c_jac = [ps.valid & (c == C) for (ps, _, _), c in zip(cbanks, ccolors)]
    jac_demand = torch.zeros((), dtype=I32, device=dev)
    for j in c_jac:
        jac_demand = torch.maximum(jac_demand, j.sum().to(I32))
    in_jacobi = c_jac + [bank_valid[n] & (jcolors[n] == C) for n in names]
    valence = jacobi_valence_kary(all_refs, all_dyn, gather(torch.cat(in_jacobi), sizes),
                                  n_bodies)

    # Per-bank index columns. The rows a body's warm start and Jacobi pass sum come in
    # segments (a contact bank's A sides, its B sides, a joint bank's body columns),
    # gathered into the single-device order.
    sink = n_bodies
    c_idx2 = [torch.cat([ps.body_a, ps.body_b]).long() for ps, _, _ in cbanks]
    c_val2 = [valence[i] for i in c_idx2]
    j_idx = {n: [joint_banks[n]["bodies"][:, j].long()
                 for j in range(2 if n in tb_names else JOINT_TYPES[n].N_BODIES)]
             for n in names}
    segments = [ps.body_a.shape[0] for ps, _, _ in cbanks for _ in range(2)]
    segments += [i.shape[0] for n in names for i in j_idx[n]]
    to_global = lambda x: gather(x, segments)

    # Rows that add nothing target the sink: a zero inside a run would change the order of
    # its sums.
    warm_tgt = [torch.where(torch.cat([ps.valid, ps.valid]), i, sink)
                for (ps, _, _), i in zip(cbanks, c_idx2)]
    warm_tgt += [torch.where(bank_valid[n], i, sink) for n in names for i in j_idx[n]]
    jac_tgt = [torch.where(torch.cat([j, j]), i, sink) for j, i in zip(c_jac, c_idx2)]
    for n in names:
        jm = bank_valid[n] & (jcolors[n] == C)
        jac_tgt += [torch.where(jm, i, sink) for i in j_idx[n]]
    warm_sum = jac_sum = None
    if segments:
        both = to_global(torch.stack([torch.cat(warm_tgt), torch.cat(jac_tgt)], -1))
        warm_sum = bk_mod.FixedOrderSum(both[:, 0], n_bodies)
        jac_sum = bk_mod.FixedOrderSum(both[:, 1], n_bodies)

    def apply_dv(v6, dv):
        return v6 + comm.psum(dv, group)

    def apply_rows(v6, fixed, vals):
        """``v6`` plus the fixed-order sums of every rank's rows ``vals``."""
        return v6 + fixed.add(torch.zeros_like(v6), to_global(vals))

    def joint_pass(v6, i7, st, n, imp, mask, jacobi: bool):
        """One masked pass of joint bank ``n``: (new impulses, [(targets, deltas)])."""
        cls, ps, idx = JOINT_TYPES[n], joint_banks[n]["prestep"], j_idx[n]
        if n in tb_names:
            a, b = idx
            ctx = JointContext(
                pos_a=st.pos[a], orn_a=st.orn[a],
                inertia_a=_inertia_rows(i7[a], valence[a] if jacobi else None), vel_a=_vel(v6, a),
                pos_b=st.pos[b], orn_b=st.orn[b],
                inertia_b=_inertia_rows(i7[b], valence[b] if jacobi else None), vel_b=_vel(v6, b),
                active=mask)
            new, da, db = cls.solve(ps, imp, ctx, h, inv_h)
            dvs = [_pack_dv(da), _pack_dv(db)]
        else:
            ctx = MultiBodyContext(pos=[st.pos[i] for i in idx], vel=[_vel(v6, i) for i in idx],
                                   inv_mass=[i7[i, 0] * valence[i] if jacobi else i7[i, 0]
                                             for i in idx], active=mask)
            new, dvs = cls.solve(ps, imp, ctx, h, inv_h)
            dvs = [_pack_dv(d) for d in dvs[:len(idx)]]
        m1 = mask[:, None]
        new = torch.where(m1, new, imp)
        out = []
        for i, d in zip(idx, dvs):
            d = torch.where(m1, d, 0.0)
            out.append((i, d / valence[i][:, None] if jacobi else d))
        return new, out

    def joint_warm(v6, i7, st, n, imp):
        cls, ps, idx = JOINT_TYPES[n], joint_banks[n]["prestep"], j_idx[n]
        live = bank_valid[n]
        if n in tb_names:
            a, b = idx
            ctx = JointContext(pos_a=st.pos[a], orn_a=st.orn[a], inertia_a=_inertia_rows(i7[a]),
                               vel_a=_vel(v6, a), pos_b=st.pos[b], orn_b=st.orn[b],
                               inertia_b=_inertia_rows(i7[b]), vel_b=_vel(v6, b), active=live)
            dvs = cls.warm_start(ps, imp, ctx)
        else:
            ctx = MultiBodyContext(pos=[st.pos[i] for i in idx], vel=[_vel(v6, i) for i in idx],
                                   inv_mass=[i7[i, 0] for i in idx], active=live)
            dvs = cls.warm_start(ps, imp, ctx)
        return [torch.where(live[:, None], _pack_dv(d), 0.0) for d in dvs[:len(idx)]]

    presteps = [ps for ps, _, _ in cbanks]
    imps = [im for _, im, _ in cbanks]
    jimps = {n: joint_banks[n]["impulse"] * bank_valid[n][:, None].float() for n in names}

    for s in range(cfg.substeps):
        if s > 0:
            v6 = torch.stack([*state.vel, *state.omega], -1)
            presteps = [contact_mod.incremental_depth_update(
                ps, _vel(v6, ps.body_a.long()), _vel(v6, ps.body_b.long()), h)
                for ps in presteps]
            state = integrate_poses(state, integrator_cfg, h)
        state = integrate_velocities(state, integrator_cfg, h)
        world_ii = state.world_inv_inertia()
        i7 = torch.stack([state.inv_mass, *world_ii], -1)
        v6 = torch.stack([*state.vel, *state.omega], -1)

        # Warm start: velocity-independent deltas of every bank.
        vals = []
        for ps, im, idx2 in zip(presteps, imps, c_idx2):
            m = ps.body_a.shape[0]
            z = Vec3.zeros(m, device=dev)
            dva, dvb = contact_mod.warm_start(ps, im, _inertia_rows(i7[idx2[:m]]),
                                              _inertia_rows(i7[idx2[m:]]), BodyVel(z, z),
                                              BodyVel(z, z))
            vals += [_pack_dv(dva), _pack_dv(dvb)]
        for n in names:
            vals += joint_warm(v6, i7, state, n, jimps[n])
        if warm_sum is not None:
            v6 = apply_rows(v6, warm_sum, torch.cat(vals))

        def contact_pass(v6, ci, mask, jacobi: bool):
            ps, idx2 = presteps[ci], c_idx2[ci]
            m = ps.body_a.shape[0]
            scale = c_val2[ci] if jacobi else None
            ia = _inertia_rows(i7[idx2[:m]], None if scale is None else scale[:m])
            ib = _inertia_rows(i7[idx2[m:]], None if scale is None else scale[m:])
            va, vb = _vel_pair(v6, idx2)
            new, nva, nvb = contact_mod.solve(ps._replace(valid=ps.valid & mask), imps[ci],
                                              ia, ib, va, vb, h, inv_h)
            p2 = torch.cat([_delta(nva, va), _delta(nvb, vb)])
            return new, (p2 / scale[:, None] if jacobi else p2)

        for _ in range(cfg.iterations_for(s)):
            for c in range(C):
                dv = torch.zeros_like(v6)
                new_imps = []
                for ci in range(len(presteps)):
                    new, p2 = contact_pass(v6, ci, ccolors[ci] == c, False)
                    new_imps.append(new)
                    dv = dv.index_add(0, c_idx2[ci], p2)
                new_j = {}
                for n in names:
                    new_j[n], parts = joint_pass(v6, i7, state, n, jimps[n],
                                                 bank_valid[n] & (jcolors[n] == c), False)
                    for i, d in parts:
                        dv = dv.index_add(0, i, d)
                imps, jimps = new_imps, new_j
                v6 = apply_dv(v6, dv)
            vals, new_imps = [], []
            for ci in range(len(presteps)):
                new, p2 = contact_pass(v6, ci, c_jac[ci], True)
                new_imps.append(new)
                vals.append(p2)
            new_j = {}
            for n in names:
                new_j[n], parts = joint_pass(v6, i7, state, n, jimps[n],
                                             bank_valid[n] & (jcolors[n] == C), True)
                vals += [d for _, d in parts]
            imps, jimps = new_imps, new_j
            if jac_sum is not None:
                v6 = apply_rows(v6, jac_sum, torch.cat(vals))
        state = state._replace(vel=Vec3(v6[:, 0], v6[:, 1], v6[:, 2]),
                               omega=Vec3(v6[:, 3], v6[:, 4], v6[:, 5]))
    state = integrate_poses(state, integrator_cfg, h)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    demand = torch.stack([jac_demand, torch.zeros((), dtype=I32, device=dev)])
    return state, imps, jimps, overflow, persist_c, persist_j, demand
