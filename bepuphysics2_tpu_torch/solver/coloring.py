"""Device-side constraint graph coloring: incremental, fixed shapes, deterministic.

Counterpart of ``color_constraints_incremental`` and ``jacobi_valence_kary`` in
``bepuphysics2_tpu/solver/coloring.py`` (reference Solver.cs:984-1093,
SequentialFallbackBatch.cs:37). Rows keep last frame's color; the rest propose the lowest
free color (from a per-row hashed offset) in a few rounds, arbitrated per (body, color) by
the lowest slot; rows past a segment's per-color capacity demote to the Jacobi bucket
(color ``num_colors``). Integer results equal the JAX function's exactly: every sort is
stable, every integer scatter reduces (min, add) so the order of writers never matters,
and ``mode="drop"`` scatters go to a sink row that is sliced off.
"""
from __future__ import annotations

import torch

from ..utils.packing import compact_true

_BIG = 2**31 - 1
I32 = torch.int32


def _segment_cumsum(x):
    return torch.cumsum(x.to(I32), dim=0, dtype=I32)


def color_constraints_incremental(refs, dyn, valid, prev_color, n_bodies: int, num_colors: int,
                                  segments=None, rounds: int = 3, churn_cap: int = None,
                                  base_used=None):
    """Incremental coloring with cross-frame color persistence (see the module note).
    ``refs`` (M, K) int32 body slots, ``dyn`` (M, K) bool dynamic endpoints (only these
    conflict), ``valid`` (M,), ``prev_color`` (M,) int32 (-1 = none); ``segments`` a list
    of static (start, size, cap); ``base_used`` (NB+1,) int32 claims of other banks.
    Returns (color, rank): color in [0, num_colors] (num_colors = Jacobi bucket); rank =
    bucket position within (segment, color), -1 outside segments or in the Jacobi bucket."""
    m, k = refs.shape
    C = num_colors
    dev = refs.device
    if C > 24:
        raise ValueError("num_colors > 24 unsupported (bitmask color search)")
    if churn_cap is None:
        churn_cap = max(min(m, 64), m // 4)
    churn_cap = min(churn_cap, m)
    maskC = (1 << C) - 1
    one = lambda t: torch.bitwise_left_shift(torch.ones_like(t), t)

    carried = valid & (prev_color >= 0) & (prev_color < C)
    color = torch.where(carried, prev_color, C).to(I32)
    unassigned = valid & ~carried

    # Per-body used-color bitmask from carried rows: at most one carried row per (body,
    # color), so an integer add of single bits is a bitwise OR.
    cbit = torch.where(carried, one(prev_color.clamp_min(0)), 0)
    cbit_flat = torch.where(dyn, cbit[:, None], 0).reshape(-1)
    used = torch.zeros(n_bodies + 1, dtype=I32, device=dev).index_add(
        0, refs.reshape(-1).long(), cbit_flat.to(I32))
    if base_used is not None:
        used = used | base_used

    # Compact the churn set.
    sel, n_un = compact_true(unassigned, churn_cap)
    live = torch.arange(churn_cap, device=dev) < n_un
    sel_l = sel.long()
    srefs = refs[sel_l]
    sdyn = dyn[sel_l] & live[:, None]
    # Preferred color offset from the body refs (int32 wrap-around arithmetic).
    h = srefs[:, 0] * -1640531527 + srefs[:, 1] * 40503
    pref = torch.remainder(torch.abs(h), C).to(I32)
    scolor = torch.full((churn_cap,), C, dtype=I32, device=dev)
    sactive = live

    cols = torch.arange(C, dtype=I32, device=dev)
    if segments:
        seg_index = torch.full((m,), -1, dtype=I32, device=dev)
        seg_remaining = []
        for si, (start, size, cap) in enumerate(segments):
            seg_index[start:start + size] = si
            kseg = carried[start:start + size]
            cseg = torch.where(carried, prev_color, C)[start:start + size]
            counts = ((cseg[:, None] == cols[None, :]) & kseg[:, None]).sum(0).to(I32)
            seg_remaining.append(cap - counts)
        s_seg = seg_index[sel_l]

        def full_bits_row():
            bits = torch.zeros(churn_cap, dtype=I32, device=dev)
            for si in range(len(segments)):
                fb = torch.where(seg_remaining[si] <= 0, one(cols), 0).sum().to(I32)
                bits = torch.where(s_seg == si, fb, bits)
            return bits

    sink = n_bodies * C
    for _ in range(rounds):
        # Mask non-dynamic endpoints on read: the sink slot used[n_bodies] gathers every
        # non-dynamic endpoint's bits and means nothing.
        ub = torch.where(sdyn, used[torch.where(sdyn, srefs, n_bodies).long()], 0)
        used_row = ub[:, 0]
        for j in range(1, k):
            used_row = used_row | ub[:, j]
        avail = (~used_row) & maskC
        if segments:
            avail = avail & ~full_bits_row()
        has = sactive & (avail != 0)
        # Lowest free color starting from the per-row preferred offset.
        rot = (torch.bitwise_right_shift(avail, pref) | torch.bitwise_left_shift(avail, C - pref)) & maskC
        low = rot & (-rot)
        idx = torch.round(torch.log2(low.clamp_min(1).float())).to(I32)
        prop = torch.remainder(idx + pref, C).to(I32)
        # Arbitrate per (body, proposed color): the lowest original slot wins.
        tgt = torch.where(sdyn & has[:, None], srefs * C + prop[:, None], sink)
        table = torch.full((n_bodies * C + 1,), _BIG, dtype=I32, device=dev).scatter_reduce(
            0, tgt.reshape(-1).long(), sel[:, None].expand(churn_cap, k).reshape(-1), "amin",
            include_self=True)
        win = has & (~sdyn | (table[tgt.long()] == sel[:, None])).all(dim=1)
        scolor = torch.where(win, prop, scolor)
        sactive = sactive & ~win
        wbit = torch.where(win, one(prop), 0)
        used = used.index_add(0, torch.where(sdyn, srefs, n_bodies).reshape(-1).long(),
                              wbit[:, None].expand(churn_cap, k).reshape(-1))
        if segments:
            for si in range(len(segments)):
                won_here = win & (s_seg == si)
                seg_remaining[si] = seg_remaining[si] - (
                    (prop[:, None] == cols[None, :]) & won_here[:, None]).sum(0).to(I32)

    color = torch.cat([color, color[:1]])
    color[torch.where(live, sel, m).long()] = scolor
    color = color[:m]

    # Capacity enforcement and bucket ranks per segment, carried rows first (stable).
    rank = torch.full((m,), -1, dtype=I32, device=dev)
    if segments:
        for start, size, cap in segments:
            cseg = color[start:start + size]
            vseg = valid[start:start + size]
            kseg = carried[start:start + size]
            oh = (cseg[:, None] == cols[None, :]) & vseg[:, None]
            oh_c = oh & kseg[:, None]
            oh_n = oh & ~kseg[:, None]
            cum_c = _segment_cumsum(oh_c)
            cum_n = _segment_cumsum(oh_n)
            tot_c = cum_c[-1][None, :]
            r = (torch.where(oh_c, cum_c - 1, 0) + torch.where(oh_n, cum_n - 1 + tot_c, 0)).sum(1)
            in_color = vseg & (cseg < C)
            demote = in_color & (r >= cap)
            color = torch.cat([color[:start], torch.where(demote, C, cseg).to(I32),
                               color[start + size:]])
            rank = torch.cat([rank[:start], torch.where(in_color & ~demote, r, -1).to(I32),
                              rank[start + size:]])
    return color, rank


def jacobi_valence_kary(refs, dyn, in_jacobi, n_bodies: int, extra_counts=None):
    """Per-body count (≥ 1) of Jacobi-bucket constraints touching each body, for mass
    splitting. ``extra_counts``: optional (n_bodies+1,) f32 counts from banks outside
    this table (the pair store), merged before the max-with-1. The counts are whole
    numbers, so the sum is exact in any order."""
    vals = (dyn & in_jacobi[:, None]).float().reshape(-1)
    val = torch.zeros(n_bodies + 1, dtype=torch.float32, device=refs.device).index_add(
        0, refs.reshape(-1).clamp_max(n_bodies).long(), vals)[:n_bodies]
    if extra_counts is not None:
        val = val + extra_counts[:n_bodies]
    return torch.clamp_min(val, 1.0)
