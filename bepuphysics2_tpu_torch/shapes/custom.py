"""Custom convex shapes: a user registers one support function and the generic GJK/MPR
narrow phase (``collision/convex.py``) collides the new type with every other convex
shape, with no tester per pair (reference Collidables/Shapes.cs:402 registration and the
CustomVoxelCollidableDemo).

    EGG = register_custom_shape(
        lambda params, d: (Vec3(...), margin),   # support point of the core + margin
        name="egg",
    )
    sim.add_shape(CustomShape(EGG, params=[...], max_radius=..., inertia_diag=(...)))

Counterpart of ``bepuphysics2_tpu/shapes/custom.py``; here a support function takes and
returns torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# type id -> support fn(params (..., 12), d: Vec3) -> (point: Vec3, margin)
CUSTOM_SUPPORTS: dict = {}
CUSTOM_NAMES: dict = {}
FIRST_CUSTOM_ID = 16  # ids 0-8 are built in; the rest up to 15 are left free
_NEXT_CUSTOM_ID = FIRST_CUSTOM_ID


def register_custom_shape(support_fn, name: str = None, type_id: int = None) -> int:
    """Register a convex support function; returns the new shape type id. The function
    takes ``params`` (..., 12), the packed shape rows, and a direction ``d`` (a ``Vec3``
    of (...,) tensors, not necessarily unit), and returns the support point of the
    shape's core in its local frame and a spherical margin, as tensors on ``d``'s
    device. ``type_id`` takes a given free id from 16 up instead of the next one, so
    that a scene carried from the JAX package keeps its ids."""
    global _NEXT_CUSTOM_ID
    tid = _NEXT_CUSTOM_ID if type_id is None else int(type_id)
    if tid < FIRST_CUSTOM_ID or tid in CUSTOM_SUPPORTS:
        raise ValueError(f"custom shape type id {tid} is built in or taken")
    _NEXT_CUSTOM_ID = max(_NEXT_CUSTOM_ID, tid + 1)
    CUSTOM_SUPPORTS[tid] = support_fn
    CUSTOM_NAMES[tid] = name or f"custom{tid}"
    return tid


def is_custom(type_id: int) -> bool:
    return type_id in CUSTOM_SUPPORTS


@dataclasses.dataclass(frozen=True)
class CustomShape:
    """An instance of a registered custom shape type: packed params and host metadata."""

    type_id: int
    params: tuple = ()
    max_radius: float = 1.0
    inertia_diag: tuple = (1.0, 1.0, 1.0)  # unit-mass inertia diagonal

    def pack(self):
        return self.type_id, list(self.params)

    def maximum_radius(self):
        return float(self.max_radius)

    def compute_inertia(self, mass: float):
        d = np.asarray(self.inertia_diag, np.float64) * mass
        return 1.0 / mass, tuple((1.0 / d).tolist())
