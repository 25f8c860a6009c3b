"""Row gathers and fixed-capacity compaction, free of host synchronisation.

``compact_true`` is the counterpart of ``torch.nonzero`` with a static output size: the
output shape never depends on the data, so the step never waits for the device to learn
a count (``torch.nonzero`` does).
"""
from __future__ import annotations

import torch

_BIG = 2**31 - 1


def gather_rows(tree, idx):
    """``tree`` (a NamedTuple, dict, or tensor, nested) with every leaf indexed by
    ``idx`` along its leading axis."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    if isinstance(tree, dict):
        return {k: gather_rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_rows(v, idx) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_rows(v, idx) for v in tree)
    return tree


def compact_true(mask: torch.Tensor, size: int, fill: int = 0):
    """Flat indices of True elements in ascending order, padded with ``fill`` to exactly
    ``size`` entries. Returns (idx (size,) int32, count)."""
    flat = mask.reshape(-1)
    m = flat.shape[0]
    keys = torch.where(flat, torch.arange(m, dtype=torch.int32, device=flat.device), _BIG)
    s = torch.sort(keys).values[:size]
    if m < size:
        s = torch.cat([s, torch.full((size - m,), _BIG, dtype=torch.int32, device=flat.device)])
    count = flat.sum()
    return torch.where(s != _BIG, s, fill).to(torch.int32), count
