"""Shape registry: fixed-capacity packed shape parameter arrays (host-side storage +
device snapshot). The port carries spheres and boxes; every other shape type of the JAX
registry is refused with the ROADMAP item that brings it.

Packed parameter layout (``params`` row, float32 × 12), as in the JAX package:
- SPHERE (id 0): [radius]
- BOX    (id 2): [half_width, half_height, half_length]
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

SHAPE_NONE = -1
SPHERE = 0
CAPSULE = 1
BOX = 2
TRIANGLE = 3
CYLINDER = 4
CONVEX_HULL = 5
COMPOUND = 6
BIG_COMPOUND = 7
MESH = 8

N_PARAMS = 12

_LATER = {
    CAPSULE: "ROADMAP queue 1 item 17 (other shapes and testers)",
    TRIANGLE: "ROADMAP queue 1 item 17 (other shapes and testers)",
    CYLINDER: "ROADMAP queue 1 item 17 (other shapes and testers)",
    CONVEX_HULL: "ROADMAP queue 1 item 17 (other shapes and testers)",
    COMPOUND: "ROADMAP queue 1 item 18 (compounds and meshes)",
    BIG_COMPOUND: "ROADMAP queue 1 item 18 (compounds and meshes)",
    MESH: "ROADMAP queue 1 item 18 (compounds and meshes)",
}


@dataclasses.dataclass(frozen=True)
class Sphere:
    radius: float

    def pack(self):
        return SPHERE, [self.radius]

    def compute_inertia(self, mass: float):
        """reference: Collidables/Sphere.cs:95."""
        inv_mass = 1.0 / mass
        inv_i = inv_mass / (0.4 * self.radius * self.radius)
        return inv_mass, (inv_i, inv_i, inv_i)

    def maximum_radius(self):
        return self.radius


@dataclasses.dataclass(frozen=True)
class Box:
    half_width: float
    half_height: float
    half_length: float

    @staticmethod
    def from_dimensions(width, height, length) -> "Box":
        return Box(width * 0.5, height * 0.5, length * 0.5)

    def pack(self):
        return BOX, [self.half_width, self.half_height, self.half_length]

    def compute_inertia(self, mass: float):
        """reference: Collidables/Box.cs:149."""
        inv_mass = 1.0 / mass
        x2 = self.half_width**2
        y2 = self.half_height**2
        z2 = self.half_length**2
        return inv_mass, (
            inv_mass * 3 / (y2 + z2),
            inv_mass * 3 / (x2 + z2),
            inv_mass * 3 / (x2 + y2),
        )

    def maximum_radius(self):
        return float(np.sqrt(self.half_width**2 + self.half_height**2 + self.half_length**2))


class _NotPorted:
    """Stands in for a shape class of the JAX package that the port does not have yet:
    constructing it, or reaching any of its attributes (``Compound.build``), raises with
    the ROADMAP item that brings it."""

    def __init__(self, name: str, type_id: int):
        self._msg = f"{name} is not ported yet: {_LATER[type_id]}"

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(self._msg)

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotImplementedError(self._msg)


Capsule = _NotPorted("Capsule", CAPSULE)
Triangle = _NotPorted("Triangle", TRIANGLE)
Cylinder = _NotPorted("Cylinder", CYLINDER)
ConvexHull = _NotPorted("ConvexHull", CONVEX_HULL)
Compound = _NotPorted("Compound", COMPOUND)
Mesh = _NotPorted("Mesh", MESH)


class ShapeData(NamedTuple):
    """Device snapshot of the registry."""

    type: torch.Tensor  # (MS,) int32, SHAPE_NONE for empty rows
    params: torch.Tensor  # (MS, N_PARAMS) float32
    max_radius: torch.Tensor  # (MS,) float32 bounding-sphere radius


class ShapeRegistry:
    """Host-side shape storage with recycled rows."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.types = np.full(capacity, SHAPE_NONE, np.int32)
        self.params = np.zeros((capacity, N_PARAMS), np.float32)
        self.max_radius = np.zeros(capacity, np.float32)
        self.shapes = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))
        self._device = {}

    def add(self, shape) -> int:
        if not isinstance(shape, (Sphere, Box)):
            type_id = shape.pack()[0] if hasattr(shape, "pack") else None
            raise NotImplementedError(
                f"{type(shape).__name__} is not ported yet: "
                f"{_LATER.get(type_id, 'ROADMAP queue 1 item 17 (other shapes and testers)')}"
            )
        if not self._free:
            raise RuntimeError("shape registry full; raise capacity")
        idx = self._free.pop()
        type_id, packed = shape.pack()
        self.types[idx] = type_id
        self.params[idx, : len(packed)] = np.asarray(packed, np.float32)
        self.params[idx, len(packed):] = 0
        self.max_radius[idx] = shape.maximum_radius()
        self.shapes[idx] = shape
        self._device = {}
        return idx

    def remove(self, idx: int) -> None:
        self.types[idx] = SHAPE_NONE
        self.shapes[idx] = None
        self._free.append(idx)
        self._device = {}

    def __getitem__(self, idx: int):
        return self.shapes[idx]

    def device(self, device) -> ShapeData:
        key = str(torch.device(device))
        if key not in self._device:
            t = lambda a: torch.from_numpy(a.copy()).to(device)
            self._device[key] = ShapeData(t(self.types), t(self.params), t(self.max_radius))
        return self._device[key]
