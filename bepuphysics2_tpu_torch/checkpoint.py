"""Checkpoint and resume: the whole simulation state as one npz.

Counterpart of ``bepuphysics2_tpu/checkpoint.py``. The reference has no engine-level
serializer (its state is rebuilt through public getters: Bodies.GetDescription
Bodies.cs:530, Solver.GetDescription Solver.cs:1413, accumulated impulses included). Here
the port's ``SimState`` (bodies, the pair store with its accumulated impulses or the legacy
convex caches, the compound child caches, joint impulses and colors) is a tree of named tuples and dicts of tensors,
so a checkpoint is its leaves in a fixed order (named-tuple fields in order, dict keys
sorted) and resuming keeps the warm starts bit for bit.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from .utils.replay import _leaves


def _rebuild(template, it):
    """``template``'s tree with every leaf replaced by the next tensor of ``it``."""
    if torch.is_tensor(template):
        return next(it)
    if template is None:  # the convex banks of the path a configuration does not run
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    if hasattr(template, "_fields"):
        return type(template)(*(_rebuild(t, it) for t in template))
    return type(template)(_rebuild(t, it) for t in template)


def state_to_bytes(state) -> bytes:
    """Serialize a SimState (or any tree of tensors) to npz bytes."""
    buf = io.BytesIO()
    np.savez(buf, *[leaf.detach().cpu().numpy() for leaf in _leaves(state)])
    return buf.getvalue()


def state_from_bytes(template, data: bytes):
    """Restore a tree serialized by ``state_to_bytes``; ``template`` (the current SimState,
    say) gives the structure, and each restored tensor lands on its leaf's device."""
    leaves = _leaves(template)
    with np.load(io.BytesIO(data)) as npz:
        arrays = [npz[f"arr_{i}"] for i in range(len(leaves))]
    for old, new in zip(leaves, arrays):
        if tuple(old.shape) != np.shape(new):
            raise ValueError(
                f"checkpoint shape mismatch: {np.shape(new)} vs expected {tuple(old.shape)} "
                "(was the checkpoint created with different capacities?)"
            )
    restored = [torch.from_numpy(a).to(old.device) for old, a in zip(leaves, arrays)]
    return _rebuild(template, iter(restored))
