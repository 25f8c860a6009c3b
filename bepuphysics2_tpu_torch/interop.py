"""State carried between the JAX package and the port, as numpy arrays.

``state_from_numpy`` turns a JAX ``SimState`` whose leaves are numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, sim.state)``) into the port's ``SimState``; only its
``bodies`` and ``store`` are read, since the store path never reads the caches or the
sleep banks. ``shapes_from_numpy`` does the same for ``ShapeData`` and
``state_to_numpy`` goes the other way. Neither package is imported here: NamedTuples are
matched by class and field name, so one identical state can feed both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .bodies import BodyState
from .collision.pairstore import PairStore
from .shapes.registry import ShapeData
from .utils.vec import Quat, Sym3, Vec3

_TYPES = {c.__name__: c for c in (BodyState, PairStore, ShapeData, Vec3, Quat, Sym3)}


def _to_torch(src, device):
    """A NamedTuple tree of numpy arrays → the port's NamedTuple of tensors, by name."""
    if hasattr(src, "_fields"):
        cls = _TYPES[type(src).__name__]
        return cls(*(_to_torch(getattr(src, f), device) for f in cls._fields))
    return torch.from_numpy(np.array(src)).to(device)


def _to_numpy(src):
    if hasattr(src, "_fields"):
        return type(src)(*(_to_numpy(v) for v in src))
    return src.detach().cpu().numpy()


def state_from_numpy(tree, device):
    """The port's ``SimState`` (bodies, store) from a JAX ``SimState`` of numpy leaves."""
    from .simulation import SimState

    return SimState(_to_torch(tree.bodies, device), _to_torch(tree.store, device))


def shapes_from_numpy(tree, device) -> ShapeData:
    """The port's ``ShapeData`` (type, params, max_radius) from the JAX one's numpy leaves."""
    return _to_torch(tree, device)


def state_to_numpy(state):
    """The port's ``SimState`` (or any NamedTuple tree of tensors) with numpy leaves."""
    return _to_numpy(state)
