"""The general solve's per-step layout: one coloring over every bank, color buckets per
contact bank, the unified two-body joint bank, and the mass-split valence.

Counterpart of the single-chip bucketed branch of ``solve_all`` in
``bepuphysics2_tpu/solver/solve.py`` (:625-1137), in the form its Pallas backend takes:
every contact bank streams in slices of the pair store's page, so color capacities and
the Jacobi capacity round to the page, and the store bank keeps its page-execution order.
Integer layouts equal the JAX package's: sorts are stable, and ``mode="drop"`` scatters
write to a sink row that is sliced off.

``FixedOrderSum`` replaces the JAX package's float scatter-adds with repeated targets
(warm starts, Jacobi slices): targets are sorted stably once per step, and each target's
run is summed in a fixed tree order, so the result is the same on every run and on every
device (a CUDA ``index_add_`` with repeated targets adds in whatever order its atomics
land).
"""
from __future__ import annotations

import torch

from ..bodies import KIND_DYNAMIC
from ..constraints.joints import JOINT_TYPES, ONE_BODY_NAMES, TWO_BODY_TYPES
from ..utils.packing import gather_rows
from .coloring import color_constraints_incremental, jacobi_valence_kary

I32 = torch.int32

# Unified two-body joint bank widths (max over the two-body and one-body types, as the JAX
# package's; padded columns are zero and ignored by each type's kernel).
U_PRESTEP = max(t.N_PRESTEP for t in TWO_BODY_TYPES)
U_IMPULSE = max(t.N_IMPULSE for t in TWO_BODY_TYPES)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[1] == width else torch.nn.functional.pad(x, (0, width - x.shape[1]))


class FixedOrderSum:
    """Sums of value rows into ``n_rows`` target rows in a fixed order. ``tgt`` (N,) holds
    each value row's target in [0, n_rows]; ``n_rows`` is a sink that is dropped. Built
    once per layout: a stable sort of the targets, then ``add`` runs a log-step segmented
    scan over each target's run and adds the run totals, one per target."""

    def __init__(self, tgt: torch.Tensor, n_rows: int):
        s, perm = torch.sort(tgt.long(), stable=True)
        n = s.shape[0]
        dev = s.device
        ar = torch.arange(n, device=dev)
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = s[1:] != s[:-1]
        start = torch.cummax(torch.where(head, ar, 0), 0).values
        tail = torch.ones(n, dtype=torch.bool, device=dev)
        tail[:-1] = head[1:]
        self.perm = perm
        self.dest = torch.where(tail, s, n_rows)
        self.n_rows = n_rows
        self.steps = []
        d = 1
        while d < n:
            self.steps.append((d, (ar - d >= start)[:, None]))
            d *= 2

    def tensors(self) -> list:
        """The layout's tensors, which ``of`` takes back."""
        return [self.perm, self.dest] + [ok for _, ok in self.steps]

    @classmethod
    def of(cls, tensors: list, n_rows: int) -> "FixedOrderSum":
        """The layout of ``tensors`` (from ``tensors``) over ``n_rows`` target rows."""
        self = cls.__new__(cls)
        self.perm, self.dest, self.n_rows = tensors[0], tensors[1], n_rows
        self.steps = [(1 << i, ok) for i, ok in enumerate(tensors[2:])]
        return self

    def add(self, dst: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """``dst`` (n_rows, K) plus, per target, the sum of its ``vals`` (N, K) rows."""
        x = vals[self.perm]
        for d, ok in self.steps:
            x = x + torch.where(ok, torch.nn.functional.pad(x[:-d], (0, 0, d, 0)), 0.0)
        ext = torch.cat([dst, dst[:1]])
        return ext.index_add(0, self.dest, x)[:self.n_rows]


def bank_live(awake, bank: dict, name: str):
    """A joint sleeps when no endpoint is awake."""
    nb = getattr(JOINT_TYPES[name], "N_BODIES", 2)
    live = bank["valid"]
    awake_any = torch.zeros_like(live)
    for j in range(nb if name not in ONE_BODY_NAMES else 1):
        awake_any = awake_any | awake[bank["bodies"][:, j].long()]
    return live & awake_any


def color_table(state, contact_banks, joint_banks, tb_names, mb_names, cfg, sb: int,
                base_used):
    """The unified coloring over every contact bank (one segment each), the unified
    two-body joint bank (one segment) and the multi-body banks (uncapped, after it), with
    the pair store's claims as ``base_used``. The table has as many body columns as the
    scene's widest constraint; narrower groups pad with body 0, not dynamic. Returns a dict
    of per-group colors and ranks, the segments' caps, the table, the joint banks'
    liveness and the colors to persist (-1 = Jacobi or unassigned, retried next frame)."""
    C = cfg.num_colors
    kind = state.kind
    dev = kind.device
    arity = max([2] + [JOINT_TYPES[n].N_BODIES for n in mb_names])

    def group(cols):
        """(m, arity) body refs and dynamic flags of a group's body columns."""
        zero = torch.zeros_like(cols[0])
        dyn = [kind[c.long()] == KIND_DYNAMIC for c in cols]
        pad = arity - len(cols)
        return (torch.stack(cols + [zero] * pad, -1),
                torch.stack(dyn + [torch.zeros_like(dyn[0])] * pad, -1))

    refs, dyns, valids, prevs, segments, caps = [], [], [], [], [], []
    off = 0
    for ps, _, prev in contact_banks:
        mi = ps.body_a.shape[0]
        r, d = group([ps.body_a, ps.body_b])
        refs.append(r)
        dyns.append(d)
        valids.append(ps.valid)
        prevs.append(prev)
        # Capacities are multiples of the streamed slice, so no slice straddles a color.
        cap_raw = max(1, -(-int(cfg.color_cap_factor * mi) // C))
        cap = min(round_up(cap_raw, sb), round_up(mi, sb))
        caps.append(cap)
        segments.append((off, mi, cap))
        off += mi
    bank_valid = {}
    mu_total = 0
    for name in tb_names + mb_names:
        bank = joint_banks[name]
        m = bank["bodies"].shape[0]
        nb = 1 if name in ONE_BODY_NAMES else getattr(JOINT_TYPES[name], "N_BODIES", 2)
        r, d = group([bank["bodies"][:, j] for j in range(nb)])
        refs.append(r)
        dyns.append(d)
        bank_valid[name] = bank_live(state.awake, bank, name)
        valids.append(bank_valid[name])
        prevs.append(bank.get("color", torch.full((m,), -1, dtype=I32, device=dev)))
        if name in tb_names:
            mu_total += m
    cap_u = min(round_up(max(1, -(-int(cfg.color_cap_factor * mu_total) // C)), 8),
                round_up(mu_total, 8))
    if mu_total:
        segments.append((off, mu_total, cap_u))
    if refs:
        all_refs = torch.cat(refs).to(I32)
        all_dyn = torch.cat(dyns)
        all_color, all_rank = color_constraints_incremental(
            all_refs, all_dyn, torch.cat(valids), torch.cat(prevs).to(I32), kind.shape[0], C,
            segments=segments, rounds=cfg.color_rounds, churn_cap=cfg.color_churn_cap,
            base_used=base_used)
    else:  # store-only scene: every constraint is colored in the store
        all_refs = torch.zeros((0, 2), dtype=I32, device=dev)
        all_dyn = torch.zeros((0, 2), dtype=torch.bool, device=dev)
        all_color = all_rank = torch.zeros(0, dtype=I32, device=dev)

    colors, ranks = [], []
    off = 0
    for r in refs:
        colors.append(all_color[off:off + r.shape[0]])
        ranks.append(all_rank[off:off + r.shape[0]])
        off += r.shape[0]
    n_c = len(contact_banks)
    ccolors = colors[:n_c]
    jcolors = dict(zip(tb_names + mb_names, colors[n_c:]))
    jranks = dict(zip(tb_names + mb_names, ranks[n_c:]))
    persist_c = [torch.where(ps.valid & (c < C), c, -1).to(I32)
                 for (ps, _, _), c in zip(contact_banks, ccolors)]
    persist_j = {n: torch.where(bank_valid[n] & (jcolors[n] < C), jcolors[n], -1).to(I32)
                 for n in tb_names + mb_names}
    return dict(ccolors=ccolors, cranks=ranks[:n_c], jcolors=jcolors, jranks=jranks,
                caps=caps, cap_u=cap_u, mu_total=mu_total, all_refs=all_refs,
                all_dyn=all_dyn, bank_valid=bank_valid, persist_c=persist_c,
                persist_j=persist_j)


def _place(valid, col, rnk, cap: int, jcap: int, C: int):
    """Bucket positions of one bank's rows: color c rows at c·cap + rank, Jacobi rows
    compacted after the C·cap color rows (up to ``jcap``), the rest at the sink B.
    Returns (pos, order (B,), present (B,), kept Jacobi rows, spill, Jacobi demand)."""
    m = valid.shape[0]
    dev = valid.device
    ncap = C * cap
    B = ncap + jcap
    jac = valid & (col == C)
    rank_j = torch.cumsum(jac.to(I32), 0, dtype=I32) - 1
    kept_j = jac & (rank_j < jcap)
    pos = torch.where(valid & (col < C), col * cap + rnk,
                      torch.where(kept_j, ncap + rank_j, B)).to(I32)
    order = torch.full((B + 1,), m, dtype=I32, device=dev)
    order[pos.long()] = torch.arange(m, dtype=I32, device=dev)
    order = order[:B]
    return pos, order, order < m, kept_j, (jac & ~kept_j).any(), jac.sum().to(I32)


def contact_bucket(ps, imp, col, rnk, cap: int, sb: int, jacobi_cap_factor: float, C: int):
    """Color-bucket layout of one (non-store) contact bank: B = C·cap + jcap rows, jcap
    rounded to the slice. Padding rows alias row m-1 and are invalid with zero impulses."""
    m = ps.body_a.shape[0]
    jcap = min(round_up(max(8, int(jacobi_cap_factor * m)), sb), round_up(m, sb))
    pos, order, present, kept_j, spill, jac_n = _place(ps.valid, col, rnk, cap, jcap, C)
    oc = torch.clamp_max(order, m - 1).long()
    ps_b, imp_g = gather_rows((ps, imp), oc)
    ps_b = ps_b._replace(valid=present & ps_b.valid)
    zero_pad = lambda x: torch.where(present.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
    imp_b = type(imp_g)(zero_pad(imp_g.penetration),
                        type(imp_g.tangent)(*map(zero_pad, imp_g.tangent)), zero_pad(imp_g.twist))
    return dict(ps=ps_b, imp=imp_b, pos=pos, cap=cap, present=present, kept_j=kept_j,
                spill=spill, jac_n=jac_n)


def joint_bucket(joint_banks, tb_names, table, jacobi_cap_factor: float, C: int):
    """The unified two-body joint bank: every type's records in one color-bucketed bank
    with a per-row type tag (prestep and impulses padded to U_PRESTEP / U_IMPULSE)."""
    cap, mu = table["cap_u"], table["mu_total"]
    bank_valid = table["bank_valid"]
    type_ids = {name: ti for ti, name in enumerate(tb_names)}
    bodies = lambda j: torch.cat([joint_banks[n]["bodies"][:, j] for n in tb_names])
    u_valid = torch.cat([bank_valid[n] for n in tb_names])
    u_color = torch.cat([table["jcolors"][n] for n in tb_names])
    u_rank = torch.cat([table["jranks"][n] for n in tb_names])
    dev = u_valid.device
    u_tag = torch.cat([torch.full((joint_banks[n]["bodies"].shape[0],), type_ids[n], dtype=I32,
                                  device=dev) for n in tb_names])
    u_ps = torch.cat([pad_cols(joint_banks[n]["prestep"], U_PRESTEP) for n in tb_names])
    u_imp = torch.cat([pad_cols(joint_banks[n]["impulse"] * bank_valid[n][:, None].float(),
                                U_IMPULSE) for n in tb_names])
    jcap = min(round_up(max(8, int(jacobi_cap_factor * mu)), 8), round_up(mu, 8))
    pos, order, present, kept_j, spill, jac_n = _place(u_valid, u_color, u_rank, cap, jcap, C)
    g = gather_rows(dict(a=bodies(0), b=bodies(1), tag=u_tag, valid=u_valid, ps=u_ps, imp=u_imp),
                    torch.clamp_max(order, mu - 1).long())
    return dict(pos=pos, present=present, live=present & g["valid"], a=g["a"], b=g["b"],
                tag=g["tag"], ps=g["ps"], imp0=torch.where(present[:, None], g["imp"], 0.0),
                cap=cap, ncap=C * cap, type_ids=type_ids, kept_j=kept_j, spill=spill,
                jac_n=jac_n)


def valence(table, in_jacobi, n_bodies: int, extra_counts):
    """Per-body mass-split valence over the table's Jacobi rows (``in_jacobi``, a list of
    each group's flags, empty for a store-only scene) plus ``extra_counts`` (the pair
    store's live Jacobi rows)."""
    flags = torch.cat(in_jacobi) if in_jacobi else torch.zeros(
        0, dtype=torch.bool, device=table["all_refs"].device)
    return jacobi_valence_kary(table["all_refs"], table["all_dyn"], flags, n_bodies,
                               extra_counts=extra_counts)


def slice_major(xa: torch.Tensor, xb: torch.Tensor, sb: int) -> torch.Tensor:
    """(B,) A-side and B-side rows → the kernels' (n_slices · 2sb,) layout: per slice,
    sb A sides then sb B sides."""
    n = xa.shape[0] // sb
    return torch.cat([xa.reshape(n, sb), xb.reshape(n, sb)], 1).reshape(-1).contiguous()
