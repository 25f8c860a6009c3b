"""Broad phase: speculative AABB overlap → fixed-capacity candidate pair list.

Counterpart of ``bepuphysics2_tpu/collision/broadphase.py``, pair for pair and in the same
order (the pair store admits pairs in list order, which fixes their slots, colors and so
the solve order; the legacy path's cache join relies on the brute force's key order):

- ``brute_force``: the exact N×N AABB test with per-row top-k compaction (``torch.topk``
  for ``lax.top_k``). Masked scores are distinct (negated column index), so the top-k
  columns of every row are the JAX package's.
- ``brute_force_rows``: one rank's block of rows of that test, for the sharded step.
- ``sweep``: the windowed sweep-and-prune along x.
- ``grid``: the sorted uniform grid with a 14-cell half stencil and a large-body set.
- ``grid2``: replicated cell entries sorted by cell key; the structure above 8,192 bodies.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bodies import KIND_DYNAMIC, KIND_EMPTY
from ..utils.packing import compact_true
from ..utils.vec import Vec3


class PairList(NamedTuple):
    a: torch.Tensor  # (MPAIR,) int32 body slot (a < b)
    b: torch.Tensor  # (MPAIR,) int32
    valid: torch.Tensor  # (MPAIR,) bool
    overflow: torch.Tensor  # () bool — candidate count exceeded capacity
    # (6,) int32 true demand counters: [candidate pairs, grid entries, grid large set,
    # max per-row candidates, cell-window overflow flag, per-row-k overflow flag].
    demand: torch.Tensor = None


def _demand(device, pairs=0, entries=0, large=0, max_row=0, window_hit=False,
            rowk_hit=False):
    """The (6,) int32 demand vector; Python constants are filled on the device (a
    host-to-device copy of each would be a synchronising call)."""
    return torch.stack([
        v.to(torch.int32) if torch.is_tensor(v)
        else torch.full((), int(v), dtype=torch.int32, device=device)
        for v in (pairs, entries, large, max_row, window_hit, rowk_hit)
    ])


def _pair_filter(kind, awake, group):
    """(N, N) lower-triangular admissibility: at least one awake dynamic, both exist,
    no shared nonzero collision group. Each pair lives in the LARGER index's row."""
    exists = kind != KIND_EMPTY
    active_dynamic = (kind == KIND_DYNAMIC) & awake
    either_active = active_dynamic[:, None] | active_dynamic[None, :]
    both_exist = exists[:, None] & exists[None, :]
    group_ok = (group[:, None] != group[None, :]) | (group == 0)[:, None]
    n = kind.shape[0]
    tl = torch.ones((n, n), dtype=torch.bool, device=kind.device).tril(diagonal=-1)
    return both_exist & either_active & group_ok & tl


def brute_force(
    aabb_min: Vec3, aabb_max: Vec3, kind, awake, group, max_pairs: int,
    row_candidates: int = 32,
) -> PairList:
    """Exact N×N AABB pair test with two-stage compaction: each row keeps its first
    ``row_candidates`` partner columns (top-k), then one fixed-size compaction gathers
    the pairs. Rows with more partners raise the overflow flag."""
    n = kind.shape[0]
    dev = kind.device
    overlap = (
        (aabb_min.x[:, None] <= aabb_max.x[None, :])
        & (aabb_min.y[:, None] <= aabb_max.y[None, :])
        & (aabb_min.z[:, None] <= aabb_max.z[None, :])
        & (aabb_max.x[:, None] >= aabb_min.x[None, :])
        & (aabb_max.y[:, None] >= aabb_min.y[None, :])
        & (aabb_max.z[:, None] >= aabb_min.z[None, :])
    )
    mask = overlap & _pair_filter(kind, awake, group)

    k = min(row_candidates, n)
    cols_iota = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    score = torch.where(mask, -cols_iota, -(2**30))
    neg_cols = torch.topk(score, k, dim=1, sorted=True).values
    valid_rk = neg_cols > -(2**30)
    cols = torch.where(valid_rk, -neg_cols, 0)
    row_counts = mask.sum(dim=1)

    count = torch.clamp_max(row_counts, k).sum()
    fi, _ = compact_true(valid_rk, max_pairs)
    payload = torch.stack(
        [torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, k), cols],
        dim=-1,
    ).reshape(n * k, 2)
    pr = payload[fi.long()]
    ai = pr[:, 0]
    bi = pr[:, 1]
    valid = torch.arange(max_pairs, device=dev) < count
    overflow = (count > max_pairs) | (row_counts > k).any()
    return PairList(
        bi.to(torch.int32), ai.to(torch.int32), valid, overflow,
        _demand(dev, pairs=row_counts.sum(), max_row=row_counts.max()),
    )


def brute_force_rows(aabb_min: Vec3, aabb_max: Vec3, kind, awake, group, row_start: int,
                     row_count: int, max_pairs: int) -> PairList:
    """Rows [row_start, row_start + row_count) of the brute force's lower-triangular pair
    matrix, for the sharded step: a rank owns one block of rows, and each pair lives in
    its larger body's row, so a pair stays on one rank from frame to frame and so does
    its cache record. Pairs come out in ascending b-major key order (row, then column)."""
    n = kind.shape[0]
    dev = kind.device
    r = lambda x: x[row_start:row_start + row_count]
    overlap = (
        (r(aabb_min.x)[:, None] <= aabb_max.x[None, :])
        & (r(aabb_min.y)[:, None] <= aabb_max.y[None, :])
        & (r(aabb_min.z)[:, None] <= aabb_max.z[None, :])
        & (r(aabb_max.x)[:, None] >= aabb_min.x[None, :])
        & (r(aabb_max.y)[:, None] >= aabb_min.y[None, :])
        & (r(aabb_max.z)[:, None] >= aabb_min.z[None, :])
    )
    exists = kind != KIND_EMPTY
    active_dynamic = (kind == KIND_DYNAMIC) & awake
    rows = torch.arange(row_start, row_start + row_count, device=dev)
    mask = (overlap & (r(exists)[:, None] & exists[None, :])
            & (r(active_dynamic)[:, None] | active_dynamic[None, :])
            & ((r(group)[:, None] != group[None, :]) | (r(group) == 0)[:, None])
            & (rows[:, None] > torch.arange(n, device=dev)[None, :]))
    count = mask.sum()
    fi, _ = compact_true(mask, max_pairs)
    ai = torch.div(fi, n, rounding_mode="floor")
    valid = torch.arange(max_pairs, device=dev) < count
    return PairList(torch.remainder(fi, n).to(torch.int32), (ai + row_start).to(torch.int32),
                    valid, count > max_pairs, _demand(dev, pairs=count))


def sweep(aabb_min: Vec3, aabb_max: Vec3, kind, awake, group, max_pairs: int,
          window: int = 64) -> PairList:
    """Windowed sweep-and-prune along x: bodies sorted by min-x (stably; empty slots
    last), each tested against the next ``window`` in that order, the first 32 hits per
    body kept. A body whose x-interval reaches past its window, or with more hits, raises
    the overflow flag."""
    n = kind.shape[0]
    dev = kind.device
    i32 = torch.int32
    exists = kind != KIND_EMPTY
    order = torch.sort(torch.where(exists, aabb_min.x, float("inf")), stable=True).indices
    s_min, s_max = aabb_min[order], aabb_max[order]
    s_kind, s_awake, s_group = kind[order], awake[order], group[order]

    ar = torch.arange(n, device=dev)
    j_pos = ar[:, None] + torch.arange(1, window + 1, device=dev)[None, :]
    jc = torch.clamp_max(j_pos, n - 1)
    in_range = j_pos < n
    o_min = Vec3(s_min.x[jc], s_min.y[jc], s_min.z[jc])
    o_max = Vec3(s_max.x[jc], s_max.y[jc], s_max.z[jc])
    ok = (in_range & (o_min.x <= s_max.x[:, None])
          & (s_min.y[:, None] <= o_max.y) & (s_max.y[:, None] >= o_min.y)
          & (s_min.z[:, None] <= o_max.z) & (s_max.z[:, None] >= o_min.z))
    o_kind, o_group = s_kind[jc], s_group[jc]
    active_i = ((s_kind == KIND_DYNAMIC) & s_awake)[:, None]
    active_j = (o_kind == KIND_DYNAMIC) & s_awake[jc]
    ok = (ok & (active_i | active_j) & (s_kind != KIND_EMPTY)[:, None] & (o_kind != KIND_EMPTY)
          & ((s_group[:, None] != o_group) | (s_group == 0)[:, None]))

    # Window overflow: some body's x-interval reaches beyond its window.
    last = torch.clamp_max(ar + window, n - 1)
    reach = exists[order] & (s_min.x[last] <= s_max.x)
    overflow_window = (reach & ~((ar + window) >= (n - 1))).any()

    # Each row's first k hits (prefix sums searched per row), then one compaction.
    k = min(32, window)
    row_cum = torch.cumsum(ok.to(i32), 1, dtype=i32)
    row_counts = row_cum[:, -1]
    ks = torch.arange(1, k + 1, dtype=i32, device=dev)
    cand = torch.clamp_max(torch.searchsorted(row_cum, ks[None, :].expand(n, k).contiguous()),
                           window - 1)
    valid_rk = (ks - 1)[None, :] < row_counts[:, None]
    count = torch.clamp_max(row_counts, k).sum()
    fi, _ = compact_true(valid_rk, max_pairs)
    ii = torch.div(fi, k, rounding_mode="floor").long()
    jj = cand[ii, torch.remainder(fi, k).long()]
    orig_i = order[ii]
    orig_j = order[torch.clamp_max(ii + 1 + jj, n - 1)]
    valid = torch.arange(max_pairs, device=dev) < count
    overflow = (count > max_pairs) | overflow_window | (row_counts > k).any()
    return PairList(torch.minimum(orig_i, orig_j).to(i32), torch.maximum(orig_i, orig_j).to(i32),
                    valid, overflow,
                    _demand(dev, pairs=row_counts.sum(), max_row=row_counts.max()))


def grid(aabb_min: Vec3, aabb_max: Vec3, kind, awake, group, max_pairs: int,
         cell_size: float = 0.0, cell_capacity: int = 16, max_large: int = 64) -> PairList:
    """Sorted uniform grid. Small bodies (extent at most the cell size) key their centre
    cell in a 30-bit key that wraps every 1,024 cells (distant aliases fail the exact AABB
    test) and sort by it; each body takes candidates from its own cell (the ones after it
    in sorted order) and 13 forward neighbours, up to ``cell_capacity`` per cell, so every
    adjacent-cell pair is seen once. Bodies larger than a cell (``max_large`` of them) are
    tested against everyone. Each body keeps its first 32 hits. ``cell_size <= 0`` means
    adaptive: 1.3 times the median live extent, at least the extent of the
    ``max_large // 2``-th largest body. Overflow (a fuller cell, more hits, more large
    bodies, more pairs) is reported."""
    n = kind.shape[0]
    dev = kind.device
    i32 = torch.int32
    exists = kind != KIND_EMPTY
    active_dynamic = (kind == KIND_DYNAMIC) & awake

    center = (aabb_min + aabb_max) * 0.5
    ext = aabb_max - aabb_min
    max_ext = torch.maximum(ext.x, torch.maximum(ext.y, ext.z))
    if cell_size and cell_size > 0:
        cs = torch.full((), cell_size, dtype=torch.float32, device=dev)
    else:
        live_ext = torch.where(exists, max_ext, float("nan"))
        cs = torch.clamp_min(_nanmedian(live_ext) * float(np.float32(1.3)), 1e-3)
        k_lim = max(2, min(max_large // 2, n))
        top_ext = torch.topk(torch.where(exists, max_ext, float("-inf")), k_lim).values
        cs = torch.maximum(cs, top_ext[k_lim - 1])
    large = exists & (max_ext > cs)
    small = exists & ~large
    inv_cs = 1.0 / cs
    cell = lambda v: torch.floor(v * inv_cs).to(i32) & 1023
    cx, cy, cz = cell(center.x), cell(center.y), cell(center.z)

    def cell_key(ix, iy, iz):
        return ((ix & 1023) << 20) | ((iy & 1023) << 10) | (iz & 1023)

    BIGKEY = 2**31 - 1
    key = torch.where(small, cell_key(cx, cy, cz), BIGKEY).to(i32)
    sorted_key, order = torch.sort(key, stable=True)
    order = order.to(i32)
    my_pos = torch.zeros(n, dtype=i32, device=dev)
    my_pos[order.long()] = torch.arange(n, dtype=i32, device=dev)
    flags = small.float() + 2.0 * active_dynamic.float() + 4.0 * exists.float()
    feat = torch.stack([aabb_min.x, aabb_min.y, aabb_min.z, aabb_max.x, aabb_max.y,
                        aabb_max.z, group.float(), flags], -1)  # (N, 8)

    # Own cell (partners after this body in sorted order) and 13 forward neighbours.
    HALF = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, -1, 0),
            (1, 0, 1), (1, 0, -1), (0, 1, 1), (0, 1, -1), (1, 1, 1), (1, 1, -1),
            (1, -1, 1), (1, -1, -1)]
    K = cell_capacity
    offs = torch.arange(K, dtype=i32, device=dev)
    cand_cols, ok_cols = [], []
    cell_count = None
    for dx, dy, dz in HALF:
        nk = cell_key(cx + dx, cy + dy, cz + dz).contiguous()
        s0 = torch.searchsorted(sorted_key, nk).to(i32)
        s1 = torch.searchsorted(sorted_key, nk, right=True).to(i32)
        if dx == dy == dz == 0:
            cell_count = s1 - s0
            s0 = my_pos + 1
        pos = s0[:, None] + offs[None, :]
        ok_cols.append(pos < s1[:, None])
        cand_cols.append(order[torch.clamp_max(pos, n - 1).long()])
    cand = torch.cat(cand_cols, 1)  # (N, 14K)
    cand_ok = torch.cat(ok_cols, 1)
    overflow_cell = (torch.where(small, cell_count, 0) > K).any()

    g = feat[cand.long()]  # (N, 14K, 8)
    g_flags = g[..., 7]
    g_small = torch.remainder(g_flags, 2.0) >= 1.0
    g_active = torch.remainder(torch.floor(g_flags / 2.0), 2.0) >= 1.0

    def overlap(lo_x, lo_y, lo_z, hi_x, hi_y, hi_z):
        return ((aabb_min.x[:, None] <= hi_x) & (aabb_max.x[:, None] >= lo_x)
                & (aabb_min.y[:, None] <= hi_y) & (aabb_max.y[:, None] >= lo_y)
                & (aabb_min.z[:, None] <= hi_z) & (aabb_max.z[:, None] >= lo_z))

    me = torch.arange(n, device=dev)[:, None]
    groupf = group.float()
    pair_ok = (cand_ok & small[:, None] & g_small & (active_dynamic[:, None] | g_active)
               & ((groupf[:, None] != g[..., 6]) | (group == 0)[:, None])
               & overlap(*(g[..., i] for i in range(6))))

    # Large bodies against everyone (N × max_large).
    large_count = large.sum()
    large_idx, _ = compact_true(large, max_large)
    large_live = torch.arange(max_large, device=dev) < large_count
    gl = feat[large_idx.long()]  # (max_large, 8)
    gl_active = torch.remainder(torch.floor(gl[None, :, 7] / 2.0), 2.0) >= 1.0
    lg_ok = (large_live[None, :] & exists[:, None] & (large_idx[None, :] != me)
             & (active_dynamic[:, None] | gl_active)
             & ((groupf[:, None] != gl[None, :, 6]) | (group == 0)[:, None])
             & overlap(*(gl[None, :, i] for i in range(6)))
             & (~large[:, None] | (me < large_idx[None, :])))  # large-large: i < j only

    all_j = torch.cat([cand, large_idx[None, :].expand(n, max_large)], 1)
    all_ok = torch.cat([pair_ok, lg_ok], 1)
    KP = 32
    iota = torch.arange(all_ok.shape[1], dtype=i32, device=dev)[None, :]
    neg_cols = torch.topk(torch.where(all_ok, -iota, -(2**30)), KP, dim=1).values
    valid_rk = neg_cols > -(2**30)
    cols = torch.where(valid_rk, -neg_cols, 0)
    row_counts = all_ok.sum(1)
    count = torch.clamp_max(row_counts, KP).sum()
    fi, _ = compact_true(valid_rk, max_pairs)
    ai = torch.div(fi, KP, rounding_mode="floor").long()
    ki = torch.remainder(fi, KP).long()
    jj = all_j[ai, torch.clamp_max(cols[ai, ki], all_j.shape[1] - 1).long()]
    valid = torch.arange(max_pairs, device=dev) < count
    overflow = ((count > max_pairs) | overflow_cell | (large_count > max_large)
                | (row_counts > KP).any())
    ai = ai.to(i32)
    return PairList(torch.minimum(ai, jj).to(i32), torch.maximum(ai, jj).to(i32), valid,
                    overflow, _demand(dev, pairs=row_counts.sum(), large=large_count,
                                      max_row=row_counts.max()))


def _round_up_int(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _nanmedian(x):
    """``jnp.nanmedian`` of a 1-D tensor as the JAX package computes it: the midpoint
    ``(lo + hi) * 0.5`` of the two middle live values (``torch.nanmedian`` returns the
    lower one), with the live count kept on the device."""
    s = torch.sort(x).values  # NaNs last
    count = (~torch.isnan(x)).sum()
    lo = torch.div(count - 1, 2, rounding_mode="floor").clamp_min(0)
    hi = torch.div(count, 2, rounding_mode="floor")
    mid = s.index_select(0, torch.stack([lo, hi]))  # a tensor index: no host read
    return (mid[0] + mid[1]) * 0.5


def grid2(
    aabb_min: Vec3,
    aabb_max: Vec3,
    kind,
    awake,
    group,
    max_pairs: int,
    cell_size: float = 0.0,
    cell_capacity: int = 16,
    max_large: int = 64,
    entry_factor: int = 7,
    cell_factor: float = 1.2,
    pair_k: int = 8,
) -> PairList:
    """Replicated-cell-entry broad phase. Each small body inserts an entry into every cell
    its AABB overlaps (at most 8 when its extent is at most the cell size); entries sort
    stably by cell key, and candidate pairs are entries within ``cell_capacity`` positions
    of each other with equal keys. A pair sharing several cells is emitted only from the
    cell holding max(min_a, min_b), the min corner of the AABB intersection. Bodies larger
    than a cell (``max_large`` of them) are tested against everyone and keep their first
    ``max(pair_k, 8)`` partners per body.

    Capacities, all reported as overflow: ``entry_factor * N`` sorted entries, the same-cell
    window, the large set and its per-body budget, ``max_pairs``. ``cell_size <= 0`` means
    adaptive: ``cell_factor`` times the median live AABB extent, at least the extent of
    the ``max_large // 2``-th largest body."""
    n = kind.shape[0]
    dev = kind.device
    i32 = torch.int32
    exists = kind != KIND_EMPTY
    active_dynamic = (kind == KIND_DYNAMIC) & awake

    ext = aabb_max - aabb_min
    max_ext = torch.maximum(ext.x, torch.maximum(ext.y, ext.z))
    if cell_size and cell_size > 0:
        cs = torch.full((), cell_size, dtype=torch.float32, device=dev)
    else:
        live_ext = torch.where(exists, max_ext, float("nan"))
        cs = torch.clamp_min(_nanmedian(live_ext) * float(np.float32(cell_factor)), 1e-3)
        k_lim = max(2, min(max_large // 2, n))
        top_ext = torch.topk(torch.where(exists, max_ext, float("-inf")), k_lim).values
        cs = torch.maximum(cs, top_ext[k_lim - 1])
    large = exists & (max_ext > cs)
    small = exists & ~large
    inv_cs = 1.0 / cs

    def cell(v):
        return torch.floor(v * inv_cs).to(i32)

    c0x, c0y, c0z = cell(aabb_min.x), cell(aabb_min.y), cell(aabb_min.z)
    ox = (cell(aabb_max.x) > c0x) & small
    oy = (cell(aabb_max.y) > c0y) & small
    oz = (cell(aabb_max.z) > c0z) & small

    def cell_key(ix, iy, iz):
        return ((ix & 1023) << 20) | ((iy & 1023) << 10) | (iz & 1023)

    BIGKEY = 2**31 - 1
    j8 = torch.arange(8, dtype=i32, device=dev)
    dx, dy, dz = j8 & 1, (j8 >> 1) & 1, (j8 >> 2) & 1
    evalid = (small[:, None]
              & ((dx[None, :] == 0) | ox[:, None])
              & ((dy[None, :] == 0) | oy[:, None])
              & ((dz[None, :] == 0) | oz[:, None]))
    ekey = torch.where(
        evalid,
        cell_key(c0x[:, None] + dx[None, :], c0y[:, None] + dy[None, :],
                 c0z[:, None] + dz[None, :]),
        BIGKEY,
    ).reshape(-1)

    entry_count = evalid.sum()
    E_CAP = min(_round_up_int(entry_factor * n, 128), 8 * n)
    # Stable: same-cell entries stay in (body, slot) order.
    skey, sidx = torch.sort(ekey, stable=True)
    skey = skey[:E_CAP]
    sbody = torch.div(sidx[:E_CAP], 8, rounding_mode="floor").to(i32)
    overflow_entries = entry_count > E_CAP

    flags = active_dynamic.float()
    feat = torch.stack([aabb_min.x, aabb_min.y, aabb_min.z, aabb_max.x, aabb_max.y,
                        aabb_max.z, group.float(), flags], -1)  # (N, 8)
    f = feat[sbody.long()]  # (E_CAP, 8)
    fmin_x, fmin_y, fmin_z = f[:, 0], f[:, 1], f[:, 2]
    fmax_x, fmax_y, fmax_z = f[:, 3], f[:, 4], f[:, 5]
    fgroup = f[:, 6]
    factive = f[:, 7] >= 1.0

    W = cell_capacity
    pos_e = torch.arange(E_CAP, dtype=i32, device=dev)

    def rolled(x, d):
        return torch.roll(x, -d, 0)

    ok_cols = []
    for d in range(1, W + 1):
        in_range = (pos_e + d) < E_CAP
        same_cell = (skey == rolled(skey, d)) & (skey != BIGKEY) & in_range
        r_min_x, r_min_y, r_min_z = rolled(fmin_x, d), rolled(fmin_y, d), rolled(fmin_z, d)
        overlap = ((fmin_x <= rolled(fmax_x, d)) & (fmax_x >= r_min_x)
                   & (fmin_y <= rolled(fmax_y, d)) & (fmax_y >= r_min_y)
                   & (fmin_z <= rolled(fmax_z, d)) & (fmax_z >= r_min_z))
        either_active = factive | rolled(factive, d)
        rgroup = rolled(fgroup, d)
        group_ok = (fgroup != rgroup) | (fgroup == 0.0)
        home_here = cell_key(cell(torch.maximum(fmin_x, r_min_x)),
                             cell(torch.maximum(fmin_y, r_min_y)),
                             cell(torch.maximum(fmin_z, r_min_z))) == skey
        ok_cols.append(same_cell & overlap & either_active & group_ok & home_here)
    ok = torch.stack(ok_cols, 1)  # (E_CAP, W)
    # A cell with more than W + 1 entries may hold pairs farther apart than the window.
    overflow_window = ((skey == rolled(skey, W)) & (skey != BIGKEY) & ((pos_e + W) < E_CAP)).any()
    pb_dense = torch.stack([rolled(sbody, d) for d in range(1, W + 1)], 1)
    row_counts = ok.sum(1)

    # Large bodies against everything (N × max_large), packed rows.
    groupf = group.float()
    me = torch.arange(n, device=dev)[:, None]
    large_count = large.sum()
    large_idx, _ = compact_true(large, max_large)
    large_live = torch.arange(max_large, device=dev) < large_count
    gl = feat[large_idx.long()]  # (max_large, 8)
    lg_ok = (large_live[None, :]
             & exists[:, None]
             & (large_idx[None, :] != me)
             & (active_dynamic[:, None] | (gl[None, :, 7] >= 1.0))
             & ((groupf[:, None] != gl[None, :, 6]) | (group == 0)[:, None])
             & (aabb_min.x[:, None] <= gl[None, :, 3]) & (aabb_max.x[:, None] >= gl[None, :, 0])
             & (aabb_min.y[:, None] <= gl[None, :, 4]) & (aabb_max.y[:, None] >= gl[None, :, 1])
             & (aabb_min.z[:, None] <= gl[None, :, 5]) & (aabb_max.z[:, None] >= gl[None, :, 2])
             & (~large[:, None] | (me < large_idx[None, :])))  # large-large: i < j only
    KL = min(max(pair_k, 8), max_large)
    lidx_dense = large_idx[None, :].expand(n, max_large)
    lbk = torch.topk(torch.where(lg_ok, lidx_dense, -1), KL, dim=1).values  # (N, KL)
    valid_lk = lbk >= 0
    lrow_counts = lg_ok.sum(1)
    overflow_lk = (lrow_counts > KL).any()

    # One compaction over both candidate sets (smalls first), one payload row gather.
    count = row_counts.sum() + torch.clamp_max(lrow_counts, KL).sum()
    pay_small = torch.stack([sbody[:, None].expand(E_CAP, W), pb_dense], -1).reshape(E_CAP * W, 2)
    pay_large = torch.stack(
        [torch.arange(n, dtype=i32, device=dev)[:, None].expand(n, KL), lbk.to(i32)], -1,
    ).reshape(n * KL, 2)
    payload = torch.cat([pay_small, pay_large])
    flat_valid = torch.cat([ok.reshape(-1), valid_lk.reshape(-1)])
    fi, _ = compact_true(flat_valid, max_pairs)
    pr = payload[fi.long()]
    pa, pb = pr[:, 0], pr[:, 1]
    valid = torch.arange(max_pairs, device=dev) < count
    overflow = ((count > max_pairs) | overflow_entries | overflow_window
                | (large_count > max_large) | overflow_lk)
    return PairList(
        torch.minimum(pa, pb), torch.maximum(pa, pb), valid, overflow,
        _demand(dev, pairs=row_counts.sum() + lrow_counts.sum(), entries=entry_count,
                large=large_count,
                max_row=torch.maximum(row_counts.max(), lrow_counts.max()),
                window_hit=overflow_window, rowk_hit=overflow_lk),
    )
