"""Broad phase: speculative AABB overlap → fixed-capacity candidate pair list.

Counterpart of ``brute_force`` in ``bepuphysics2_tpu/collision/broadphase.py``: the exact
N×N AABB test with per-row top-k compaction (``torch.topk`` for ``lax.top_k``). Masked
scores are distinct (negated column index), so the top-k columns of every row are the
same as the JAX package's. The sorted-grid and sweep broad phases are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

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
