"""CompoundBuilder: accumulate posed children with masses into a compound shape and its
combined inertia (reference Collidables/CompoundBuilder.cs: each child's inertia summed
with its parallel-axis offset, the children recentered on the center of mass).

Counterpart of ``bepuphysics2_tpu/shapes/builder.py``; host-side numpy throughout."""
from __future__ import annotations

import numpy as np


def _quat_to_matrix(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _child_inertia_tensor(shape_obj, mass: float) -> np.ndarray:
    """A child's 3x3 inertia tensor about its own center, in its local frame."""
    res = shape_obj.compute_inertia(mass)
    if len(res) == 3:  # a full symmetric inverse inertia (hulls, meshes)
        return np.linalg.inv(np.asarray(res[2], np.float64))
    d = np.asarray(res[1], np.float64)
    return np.diag(1.0 / np.maximum(d, 1e-30))


class CompoundBuilder:
    """Accumulate (shape, local pose, mass) children; ``build`` returns what a dynamic
    compound body needs: the children recentered, the total inverse mass, the combined
    inverse inertia about the center of mass, and the center's offset."""

    def __init__(self, sim):
        self.sim = sim
        self._children = []  # (shape_id, shape_obj, pos, orn, mass)

    def add(self, shape_obj, position, mass: float, orientation=(0.0, 0.0, 0.0, 1.0)):
        shape_id = self.sim.add_shape(shape_obj)
        self._children.append(
            (shape_id, shape_obj, np.asarray(position, np.float64),
             np.asarray(orientation, np.float64), float(mass))
        )
        return self

    def build(self):
        """(compound_children, inv_mass, inv_inertia6, center_of_mass): the children are
        recentered on the center of mass, ready for ``Compound.build``; ``inv_inertia6``
        is (xx, yx, yy, zx, zy, zz) about the center of mass."""
        if not self._children:
            raise ValueError("CompoundBuilder has no children")
        total_mass = sum(c[4] for c in self._children)
        com = sum(c[2] * c[4] for c in self._children) / total_mass

        inertia = np.zeros((3, 3), np.float64)
        for _, shape_obj, pos, orn, mass in self._children:
            rot = _quat_to_matrix(orn)
            world = rot @ _child_inertia_tensor(shape_obj, mass) @ rot.T
            r = pos - com
            # Parallel axis: I += m(|r|^2 E - r r^T).
            world = world + mass * (float(r @ r) * np.eye(3) - np.outer(r, r))
            inertia = inertia + world

        inv = np.linalg.inv(inertia)
        inv6 = (
            float(inv[0, 0]), float(inv[1, 0]), float(inv[1, 1]),
            float(inv[2, 0]), float(inv[2, 1]), float(inv[2, 2]),
        )
        children = [
            (shape_id, tuple((pos - com).tolist()), tuple(orn.tolist()))
            for shape_id, _, pos, orn, _ in self._children
        ]
        return children, 1.0 / total_mass, inv6, tuple(com.tolist())

    def build_body(self, position, **kw):
        """Register the compound shape and return a BodyDescription whose center (the
        center of mass) sits at ``position + com``."""
        from ..bodies import BodyDescription
        from .registry import Compound

        children, inv_mass, inv6, com = self.build()
        shape_id = self.sim.add_shape(Compound.build(children))
        p = tuple(np.asarray(position, np.float64) + np.asarray(com))
        return BodyDescription(
            position=p, shape=shape_id, inv_mass=inv_mass, inv_inertia=inv6, **kw
        )
