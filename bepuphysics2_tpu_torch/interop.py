"""State carried between the JAX package and the port, as numpy arrays.

``state_from_numpy`` turns a JAX ``SimState`` whose leaves are numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, sim.state)``) into the port's ``SimState``: bodies,
the legacy convex caches, the compound child caches, joint impulses and colors, and the
pair store (None in a legacy configuration, in both packages; a compound child cache
sized for compound-vs-compound records carries as it is). ``shapes_from_numpy`` does the same for
``ShapeData`` (its hull pool, compound and mesh child rows, triangles and cluster tables
included),
``joint_banks_from_numpy`` for the joint banks a step takes (``JointTypeStore.device()``
dicts), and ``state_to_numpy`` goes the other way. Neither package is imported here: NamedTuples are
matched by class and field name, so one identical state can feed both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .bodies import BodyState
from .collision.narrowphase import PairCache
from .collision.pairstore import PairStore
from .constraints.contact import ContactImpulses, ContactPrestep
from .shapes.custom import FIRST_CUSTOM_ID, is_custom
from .shapes.registry import ShapeData, hull_rows
from .utils.spring import SpringSettings
from .utils.vec import Quat, Sym3, Vec2, Vec3

_TYPES = {c.__name__: c for c in (BodyState, ContactImpulses, ContactPrestep, PairCache,
                                  PairStore, ShapeData, SpringSettings, Vec2, Vec3, Quat, Sym3)}


def _to_torch(src, device):
    """A NamedTuple or dict tree of numpy arrays → the port's tree of tensors, by name."""
    if src is None:
        return None
    if hasattr(src, "_fields"):
        cls = _TYPES[type(src).__name__]
        if cls is ShapeData:
            return shapes_from_numpy(src, device)
        return cls(*(_to_torch(getattr(src, f), device) for f in cls._fields))
    if isinstance(src, dict):
        return {k: _to_torch(v, device) for k, v in src.items()}
    return torch.from_numpy(np.array(src)).to(device)


def _to_numpy(src):
    if src is None:
        return None
    if hasattr(src, "_fields"):
        return type(src)(*(_to_numpy(v) for v in src))
    if isinstance(src, dict):
        return {k: _to_numpy(v) for k, v in src.items()}
    return src.detach().cpu().numpy()


def state_from_numpy(tree, device):
    """The port's ``SimState`` from a JAX ``SimState`` of numpy leaves."""
    from .simulation import SimState

    return SimState(*(_to_torch(getattr(tree, f), device) for f in SimState._fields))


def shapes_from_numpy(tree, device) -> ShapeData:
    """The port's ``ShapeData`` from the JAX one's numpy leaves: the hull pool with each
    shape's table of pool rows (``hull_rows``) in place of the JAX support windows. Every
    custom type id in it must be registered in the port (``register_custom_shape``)."""
    types = np.asarray(tree.type)
    missing = sorted({int(t) for t in types if t >= FIRST_CUSTOM_ID and not is_custom(int(t))})
    if missing:
        raise ValueError(f"custom shape types {missing} are not registered in the port")
    rows = hull_rows(np.asarray(tree.hull_start), np.asarray(tree.hull_count))
    return ShapeData(*(_to_torch(rows if f == "hull_rows" else getattr(tree, f), device)
                       for f in ShapeData._fields))


def joint_banks_from_numpy(banks: dict, device) -> dict:
    """{name: {bodies, valid, prestep[, impulse]}} of numpy arrays → tensors on ``device``."""
    return _to_torch(banks, device)


def state_to_numpy(state):
    """The port's ``SimState`` (or any NamedTuple or dict tree of tensors) with numpy leaves."""
    return _to_numpy(state)
