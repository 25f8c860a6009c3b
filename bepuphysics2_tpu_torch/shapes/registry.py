"""Shape registry: fixed-capacity packed shape parameter arrays (host-side storage +
device snapshot). The port carries spheres, capsules, boxes, triangles, cylinders, convex
hulls, registered custom convex shapes (``shapes/custom.py``), compounds of them and
triangle meshes. ``BIG_COMPOUND`` is a type id the JAX package reserves and no shape
class registers; the port reserves it too and treats it as a compound.

Packed parameter layout (``params`` row, float32 × 12), as in the JAX package:
- SPHERE   (id 0): [radius]
- CAPSULE  (id 1): [radius, half_length]  (axis = local Y)
- BOX      (id 2): [half_width, half_height, half_length]
- TRIANGLE (id 3): [ax, ay, az, bx, by, bz, cx, cy, cz]
- CYLINDER (id 4): [radius, half_length]  (axis = local Y)
- CONVEX_HULL (id 5): none; its vertices live in the hull pool (``ShapeData.hull_*``),
  one run of ``hull_count`` rows from ``hull_start`` per shape.
- COMPOUND (id 6): none; its children live in the child pool (``ShapeData.child_*``),
  Morton-ordered and grouped into bounding clusters (``ShapeData.cl_*``).
- MESH (id 8): none; its triangles live in the child pool as children of shape row -1
  (vertices in ``child_tri``), Morton-ordered and clustered as a compound's children.
- custom (ids from 16): the parameters its support function reads.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.vec import Sym3
from .custom import CustomShape, is_custom

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
class Capsule:
    radius: float
    half_length: float

    def pack(self):
        return CAPSULE, [self.radius, self.half_length]

    def compute_inertia(self, mass: float):
        """reference: Collidables/Capsule.cs:159 (cylinder + sphere-caps volume blend)."""
        inv_mass = 1.0 / mass
        r2 = self.radius * self.radius
        h2 = self.half_length * self.half_length
        cyl_vol = 2 * self.half_length * r2 * np.pi
        sph_vol = (4.0 / 3.0) * r2 * self.radius * np.pi
        inv_total = 1.0 / (cyl_vol + sph_vol)
        cyl_vol *= inv_total
        sph_vol *= inv_total
        ixx = inv_mass / (
            cyl_vol * ((3.0 / 12.0) * r2 + (4.0 / 12.0) * h2)
            + sph_vol * ((2.0 / 5.0) * r2 + (6.0 / 8.0) * self.radius * self.half_length + h2)
        )
        iyy = inv_mass / (cyl_vol * 0.5 * r2 + sph_vol * (2.0 / 5.0) * r2)
        return inv_mass, (ixx, iyy, ixx)

    def maximum_radius(self):
        return self.radius + self.half_length


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


@dataclasses.dataclass(frozen=True)
class Cylinder:
    radius: float
    half_length: float

    def pack(self):
        return CYLINDER, [self.radius, self.half_length]

    def compute_inertia(self, mass: float):
        """reference: Collidables/Cylinder.cs:166."""
        inv_mass = 1.0 / mass
        diag = inv_mass / ((4 * 0.0833333333) * self.half_length**2 + 0.25 * self.radius**2)
        return inv_mass, (diag, 2.0 * inv_mass / (self.radius**2), diag)

    def maximum_radius(self):
        return float(np.sqrt(self.radius**2 + self.half_length**2))


@dataclasses.dataclass(frozen=True)
class Triangle:
    a: tuple
    b: tuple
    c: tuple

    def pack(self):
        return TRIANGLE, [*self.a, *self.b, *self.c]

    def compute_inertia(self, mass: float):
        """Uniform thin-lamina triangle inertia about the shape-local origin (reference
        Collidables/Triangle.cs:112, MeshInertiaHelper.cs):
        C = (A/12)·(Σᵢ vᵢvᵢᵀ + s sᵀ), s = Σᵢ vᵢ; I = σ(tr C·𝟙 − C)."""
        verts = np.asarray([self.a, self.b, self.c], np.float64)
        area = 0.5 * np.linalg.norm(np.cross(verts[1] - verts[0], verts[2] - verts[0]))
        s = verts.sum(axis=0)
        c2 = (verts[:, :, None] * verts[:, None, :]).sum(axis=0) + np.outer(s, s)
        c2 *= area / 12.0
        inertia = (mass / max(area, 1e-30)) * (np.trace(c2) * np.eye(3) - c2)
        inv = np.linalg.inv(inertia)
        inv_mass = 1.0 / mass
        return inv_mass, (inv[0, 0], inv[1, 1], inv[2, 2]), inv

    def maximum_radius(self):
        return float(max(np.linalg.norm(self.a), np.linalg.norm(self.b), np.linalg.norm(self.c)))


def _oriented(pts, hull):
    """The vertices (a, b, c) of each facet of a scipy hull, wound outward."""
    for simplex, eq in zip(hull.simplices, hull.equations):
        a, b, c = pts[simplex]
        if np.dot(np.cross(b - a, c - a), eq[:3]) < 0:
            b, c = c, b
        yield a, b, c


@dataclasses.dataclass(frozen=True)
class ConvexHull:
    """Convex hull of a point cloud: the hull's vertices, recentred on its volume
    centroid (reference Collidables/ConvexHullHelper.cs:87). The device keeps only the
    vertices, in the registry's hull pool: support mapping needs nothing else."""

    points: tuple  # hull vertices (recentred), as a tuple of (x, y, z) tuples
    center_offset: tuple = (0.0, 0.0, 0.0)  # the centroid in the input's frame

    @staticmethod
    def from_points(points) -> "ConvexHull":
        """The port's own quickhull (``native/hull.cpp``, built with the host compiler
        at first use); scipy's qhull where no compiler is present."""
        from .. import native

        pts = np.asarray(points, np.float64)
        res = native.quickhull(pts)
        if res is not None:
            vert_ids, _tris, centroid, _volume = res
            verts = pts[vert_ids] - centroid
            return ConvexHull(tuple(map(tuple, verts.tolist())), tuple(centroid.tolist()))

        from scipy.spatial import ConvexHull as QHull

        hull = QHull(pts)
        verts = pts[hull.vertices]
        # Volume centroid from signed tetrahedra on the outward-wound facets.
        total_v = 0.0
        centroid = np.zeros(3)
        for a, b, c in _oriented(pts, hull):
            v = np.dot(a, np.cross(b, c)) / 6.0
            total_v += v
            centroid += v * (a + b + c) / 4.0
        centroid = centroid / total_v if abs(total_v) > 1e-12 else verts.mean(0)
        verts = verts - centroid
        return ConvexHull(tuple(map(tuple, verts.tolist())), tuple(centroid.tolist()))

    def pack(self):
        return CONVEX_HULL, []

    def compute_inertia(self, mass: float):
        """Solid inertia from a tetrahedron decomposition about the origin (the hull's
        centroid): the native path, or scipy's where no compiler is present."""
        from .. import native

        pts = np.asarray(self.points, np.float64)
        res = native.quickhull(pts)
        if res is not None:
            out = native.hull_inertia(pts, res[1], mass)
            if out is not None:
                inv6, inv_mass = out
                inv = np.array([[inv6[0], inv6[1], inv6[3]],
                                [inv6[1], inv6[2], inv6[4]],
                                [inv6[3], inv6[4], inv6[5]]])
                return inv_mass, (inv[0, 0], inv[1, 1], inv[2, 2]), inv

        from scipy.spatial import ConvexHull as QHull

        hull = QHull(pts)
        covariance = np.zeros((3, 3))
        total_v = 0.0
        # Covariance of the canonical tetrahedron (unit tet at the origin).
        canonical = np.array([[1 / 60.0, 1 / 120.0, 1 / 120.0],
                              [1 / 120.0, 1 / 60.0, 1 / 120.0],
                              [1 / 120.0, 1 / 120.0, 1 / 60.0]])
        for a, b, c in _oriented(pts, hull):
            m = np.stack([a, b, c])
            det = np.dot(a, np.cross(b, c))
            covariance += det * (m.T @ canonical @ m)
            total_v += det / 6.0
        if abs(total_v) < 1e-12:
            raise ValueError("degenerate hull: zero volume")
        covariance *= mass / abs(total_v)
        inertia = np.eye(3) * np.trace(covariance) - covariance
        inv = np.linalg.inv(inertia)
        return 1.0 / mass, (inv[0, 0], inv[1, 1], inv[2, 2]), inv

    def maximum_radius(self):
        return float(np.linalg.norm(np.asarray(self.points), axis=1).max())


@dataclasses.dataclass(frozen=True)
class Compound:
    """A rigid collection of posed convex children (reference Collidables/Compound.cs).
    ``children`` is a tuple of (shape_id, local_position(3), local_orientation(4))."""

    children: tuple

    @staticmethod
    def build(children) -> "Compound":
        norm = []
        for c in children:
            shape_id, pos = c[0], tuple(c[1])
            orn = tuple(c[2]) if len(c) > 2 else (0.0, 0.0, 0.0, 1.0)
            norm.append((int(shape_id), pos, orn))
        return Compound(tuple(norm))

    def pack(self):
        return COMPOUND, []

    def maximum_radius(self):
        # The registry recomputes it with the children's radii.
        return max((np.linalg.norm(c[1]) for c in self.children), default=0.0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle soup collidable (reference Collidables/Mesh.cs:36). The registry stores
    its triangles Morton-ordered in the shared child pool and groups them into bounding
    clusters (``ShapeData.cl_*``), in place of the reference's embedded tree. Triangles
    are one-sided: contacts come only from the side their winding normal faces."""

    triangles: tuple  # tuple of ((ax,ay,az),(bx,by,bz),(cx,cy,cz))
    scale: tuple = (1.0, 1.0, 1.0)

    @staticmethod
    def build(triangles, scale=(1.0, 1.0, 1.0)) -> "Mesh":
        s = np.asarray(scale, np.float64)
        tris = tuple(
            tuple(tuple((np.asarray(v, np.float64) * s).tolist()) for v in t) for t in triangles
        )
        return Mesh(tris, tuple(np.asarray(scale).tolist()))

    def pack(self):
        return MESH, []

    def compute_inertia(self, mass: float):
        """Closed-mesh inertia about the volume centroid (reference
        MeshInertiaHelper.ComputeClosedInertia, MeshInertiaHelper.cs:160), for a closed,
        consistently wound mesh: (inv_mass, inverse diagonal, inverse 3x3)."""
        inv_mass, inv, _center = self.compute_inertia_with_center(mass)
        return inv_mass, (inv[0, 0], inv[1, 1], inv[2, 2]), inv

    def compute_inertia_with_center(self, mass: float):
        """(inv_mass, inverse inertia 3x3 about the center of mass, center)."""
        volume, inertia_origin, center = mesh_closed_second_moment(self.triangles, mass)
        # Parallel axis: I_com = I_origin - m((c.c) E - c c^T).
        inertia = inertia_origin - mass * (
            np.dot(center, center) * np.eye(3) - np.outer(center, center)
        )
        return 1.0 / mass, np.linalg.inv(inertia), center

    def maximum_radius(self):
        return float(max((np.linalg.norm(v) for t in self.triangles for v in t), default=0.0))


def _second_moment(tris, weights):
    """sum_t weights_t (a a^T + b b^T + c c^T + s s^T), s = a + b + c."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    s = a + b + c
    vvt = sum(np.einsum("ti,tj->tij", v, v) for v in (a, b, c, s))
    return np.einsum("t,tij->ij", weights, vvt)


def mesh_closed_second_moment(triangles, mass: float):
    """Signed-tetrahedron integration over a closed triangle list (reference
    MeshInertiaHelper.ComputeClosedInertia, MeshInertiaHelper.cs:122,160): each triangle
    forms a tetrahedron with the origin, whose second moment is (V/20)(sum v v^T + s s^T).
    Returns (volume, inertia about the origin for total ``mass``, center of mass)."""
    tris = np.asarray(triangles, np.float64)
    if tris.size == 0:
        raise ValueError("mesh has no triangles")
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    vols = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0
    volume = float(vols.sum())
    if abs(volume) < 1e-30:
        raise ValueError("mesh encloses no volume (open or degenerate)")
    c2 = _second_moment(tris, vols / 20.0)
    inertia = (mass / volume) * (np.trace(c2) * np.eye(3) - c2)
    center = np.einsum("t,ti->i", vols, (a + b + c) / 4.0) / volume
    return volume, inertia, center


def mesh_open_inertia(triangles, mass: float):
    """Surface-lamina inertia of an open mesh about the origin (reference
    MeshInertiaHelper.ComputeOpenInertia, MeshInertiaHelper.cs:280): the area-weighted
    sum of thin-triangle second moments. Returns (inverse inertia 3x3, center of area)."""
    tris = np.asarray(triangles, np.float64)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = float(areas.sum())
    if total < 1e-30:
        raise ValueError("mesh has no area")
    c2 = _second_moment(tris, areas / 12.0)
    inertia = (mass / total) * (np.trace(c2) * np.eye(3) - c2)
    center = np.einsum("t,ti->i", areas, (a + b + c) / 3.0) / total
    return np.linalg.inv(inertia), center


class ShapeData(NamedTuple):
    """Device snapshot of the registry (the JAX ShapeData's fields, less its 64-point
    hull support windows: the port gathers each hull's vertices from the pool)."""

    type: torch.Tensor  # (MS,) int32, SHAPE_NONE for empty rows
    params: torch.Tensor  # (MS, N_PARAMS) float32
    max_radius: torch.Tensor  # (MS,) float32 bounding-sphere radius
    hull_x: torch.Tensor  # (HULL_POOL,) flat hull vertex pool
    hull_y: torch.Tensor
    hull_z: torch.Tensor
    hull_start: torch.Tensor  # (MS,) int32 the shape's first pool row
    hull_count: torch.Tensor  # (MS,) int32 its vertex count
    # (MS, H) int32 each shape's pool rows, -1 past its count; H = the largest count
    # (at least 1), so a support gathers one hull's vertices at once (``hull_rows``).
    hull_rows: torch.Tensor
    # Compound and mesh child pool: per child a shape row + local pose (-1 rows are mesh
    # triangles, whose vertices live in child_tri).
    child_shape: torch.Tensor  # (CHILD_POOL,) int32
    child_pos: torch.Tensor  # (CHILD_POOL, 3)
    child_orn: torch.Tensor  # (CHILD_POOL, 4)
    child_tri: torch.Tensor  # (CHILD_POOL, 9)
    child_start: torch.Tensor  # (MS,) int32
    child_count: torch.Tensor  # (MS,) int32
    # Per-child conservative AABB in the compound's local frame.
    child_aabb_min: torch.Tensor  # (CHILD_POOL, 3)
    child_aabb_max: torch.Tensor  # (CHILD_POOL, 3)
    # Child clusters of CLUSTER_SIZE Morton-ordered children: (NCOMP, CW[, 3]).
    cl_min: torch.Tensor
    cl_max: torch.Tensor
    cl_first: torch.Tensor  # int32 first child-pool row
    cl_count: torch.Tensor  # int32 children in the cluster (0 = dead)
    shape_cluster_row: torch.Tensor  # (MS,) int32 row into cl_* (-1 = not a compound)


def hull_rows(start, count) -> np.ndarray:
    """(MS, H) int32 pool rows of each shape's hull vertices, -1 past its count, from the
    per-shape ``start`` and ``count``; H is the largest count, at least 1."""
    start, count = np.asarray(start, np.int64), np.asarray(count, np.int64)
    k = np.arange(max(1, int(count.max(initial=0))))
    return np.where(k < count[:, None], start[:, None] + k, -1).astype(np.int32)


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Stable Morton-code ordering of points over their bounding box (10 bits/axis)."""
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-9)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable")


def _round_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _local_half_extents(type_id: int, params, max_radius: float) -> np.ndarray:
    """Axis-aligned half extents of a shape in its own frame (bounding sphere for types
    without a formula)."""
    if type_id == BOX:
        return np.asarray(params[:3], np.float64)
    if type_id == CAPSULE:
        r, hl = float(params[0]), float(params[1])
        return np.array([r, hl + r, r])
    if type_id == CYLINDER:
        r, hl = float(params[0]), float(params[1])
        return np.array([r, hl, r])
    if type_id == SPHERE:
        r = float(params[0])
        return np.array([r, r, r])
    return np.array([max_radius] * 3, np.float64)


def _quat_abs_rot(q) -> np.ndarray:
    """|R(q)| — elementwise absolute rotation matrix (conservative AABB rotation)."""
    x, y, z, w = (float(v) for v in q)
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    return np.abs(r)


_SHAPES = (Sphere, Capsule, Box, Triangle, Cylinder, ConvexHull, Compound, Mesh, CustomShape)


class ShapeRegistry:
    """Host-side shape storage with recycled rows."""

    HULL_POOL = 4096  # total hull vertices across all hull shapes (no limit per hull)
    CHILD_POOL = 8192  # total compound children and mesh triangles across all shapes
    CLUSTER_SIZE = 16  # children per acceleration cluster (ShapeData.cl_*)

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.types = np.full(capacity, SHAPE_NONE, np.int32)
        self.params = np.zeros((capacity, N_PARAMS), np.float32)
        self.max_radius = np.zeros(capacity, np.float32)
        self.hull_pool = np.zeros((self.HULL_POOL, 3), np.float32)
        self.hull_start = np.zeros(capacity, np.int32)
        self.hull_count = np.zeros(capacity, np.int32)
        self._hull_used = 0
        self.child_shape = np.full(self.CHILD_POOL, -1, np.int32)
        self.child_pos = np.zeros((self.CHILD_POOL, 3), np.float32)
        self.child_orn = np.zeros((self.CHILD_POOL, 4), np.float32)
        self.child_orn[:, 3] = 1.0
        self.child_tri = np.zeros((self.CHILD_POOL, 9), np.float32)
        self.child_aabb_min = np.zeros((self.CHILD_POOL, 3), np.float32)
        self.child_aabb_max = np.zeros((self.CHILD_POOL, 3), np.float32)
        self.child_start = np.zeros(capacity, np.int32)
        self.child_count = np.zeros(capacity, np.int32)
        self._child_used = 0
        self._clusters = {}  # shape row -> (min (k,3), max (k,3), first (k,), count (k,))
        self.shapes = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))
        self._device = {}

    def add(self, shape) -> int:
        if not isinstance(shape, _SHAPES):
            raise NotImplementedError(
                f"{type(shape).__module__}.{type(shape).__name__} is not a shape of the port: "
                "build it from bepuphysics2_tpu_torch's shape classes")
        if isinstance(shape, CustomShape) and not is_custom(shape.type_id):
            raise ValueError(f"custom shape type {shape.type_id} is not registered "
                             "(shapes.custom.register_custom_shape)")
        if not self._free:
            raise RuntimeError("shape registry full; raise capacity")
        type_id, packed = shape.pack()
        pts = np.asarray(shape.points, np.float32) if type_id == CONVEX_HULL else None
        if pts is not None and self._hull_used + len(pts) > self.HULL_POOL:
            raise RuntimeError("hull vertex pool full")
        idx = self._free.pop()
        self.types[idx] = type_id
        self.params[idx, : len(packed)] = np.asarray(packed, np.float32)
        self.params[idx, len(packed):] = 0
        self.max_radius[idx] = shape.maximum_radius()
        if pts is not None:
            self.hull_start[idx] = self._hull_used
            self.hull_count[idx] = len(pts)
            self.hull_pool[self._hull_used:self._hull_used + len(pts)] = pts
            self._hull_used += len(pts)
        elif type_id == COMPOUND:
            self._add_children(idx, shape)
        elif type_id == MESH:
            self._add_triangles(idx, shape)
        self.shapes[idx] = shape
        self._device = {}
        return idx

    def _add_children(self, idx: int, shape: Compound) -> None:
        n = len(shape.children)
        if self._child_used + n > self.CHILD_POOL:
            raise RuntimeError("child pool full")
        self.child_start[idx] = self._child_used
        self.child_count[idx] = n
        cent = np.array([c[1] for c in shape.children], np.float64).reshape(n, 3)
        order = _morton_order(cent)
        radius = 0.0
        mins = np.zeros((n, 3))
        maxs = np.zeros((n, 3))
        for k, src in enumerate(order):
            cs, cpos, corn = shape.children[src]
            row = self._child_used + k
            self.child_shape[row] = cs
            self.child_pos[row] = cpos
            self.child_orn[row] = corn
            # Conservative local AABB: rotated child extents + offset.
            e = _quat_abs_rot(corn) @ _local_half_extents(
                int(self.types[cs]), self.params[cs], float(self.max_radius[cs])
            )
            mins[k] = np.asarray(cpos) - e
            maxs[k] = np.asarray(cpos) + e
            self.child_aabb_min[row] = mins[k]
            self.child_aabb_max[row] = maxs[k]
            radius = max(radius, float(np.linalg.norm(cpos)) + float(self.max_radius[cs]))
        self.max_radius[idx] = radius
        self._build_clusters(idx, mins, maxs)
        self._child_used += n

    def _add_triangles(self, idx: int, shape: Mesh) -> None:
        n = len(shape.triangles)
        if self._child_used + n > self.CHILD_POOL:
            raise RuntimeError("child pool full (mesh triangles)")
        self.child_start[idx] = self._child_used
        self.child_count[idx] = n
        tris = np.asarray(shape.triangles, np.float64).reshape(n, 3, 3)
        order = _morton_order(tris.mean(axis=1))
        mins = tris[order].min(axis=1)
        maxs = tris[order].max(axis=1)
        rows = self._child_used + np.arange(n)
        self.child_shape[rows] = -1
        self.child_tri[rows] = tris[order].astype(np.float32).reshape(n, 9)
        self.child_aabb_min[rows] = mins
        self.child_aabb_max[rows] = maxs
        self._build_clusters(idx, mins, maxs)
        self._child_used += n

    def _build_clusters(self, idx: int, mins: np.ndarray, maxs: np.ndarray) -> None:
        """Group the (Morton-ordered) children written for shape ``idx`` into
        CLUSTER_SIZE-sized AABBs (union of member child AABBs, shape-local frame)."""
        cs = self.CLUSTER_SIZE
        n = mins.shape[0]
        cl_min, cl_max, firsts, counts = [], [], [], []
        for lo in range(0, n, cs):
            hi = min(lo + cs, n)
            cl_min.append(mins[lo:hi].min(axis=0))
            cl_max.append(maxs[lo:hi].max(axis=0))
            firsts.append(self._child_used + lo)
            counts.append(hi - lo)
        self._clusters[idx] = (
            np.asarray(cl_min, np.float32).reshape(-1, 3),
            np.asarray(cl_max, np.float32).reshape(-1, 3),
            np.asarray(firsts, np.int32),
            np.asarray(counts, np.int32),
        )

    def remove(self, idx: int) -> None:
        self.types[idx] = SHAPE_NONE
        self.shapes[idx] = None
        self._clusters.pop(idx, None)
        self._free.append(idx)
        self._device = {}

    def __getitem__(self, idx: int):
        return self.shapes[idx]

    def device(self, device) -> ShapeData:
        key = str(torch.device(device))
        if key not in self._device:
            # Clusters pad to (NCOMP, CW), both rounded up to powers of two, as in the
            # JAX registry.
            rows = sorted(self._clusters.keys())
            ncomp = _round_pow2(max(1, len(rows)))
            cw = _round_pow2(max(1, max((len(self._clusters[r][2]) for r in rows), default=1)))
            cl_min = np.zeros((ncomp, cw, 3), np.float32)
            cl_max = np.full((ncomp, cw, 3), -1.0, np.float32)  # dead: max < min
            cl_first = np.zeros((ncomp, cw), np.int32)
            cl_count = np.zeros((ncomp, cw), np.int32)
            shape_cluster_row = np.full(self.capacity, -1, np.int32)
            for slot, r in enumerate(rows):
                mn, mx, fi, cnt = self._clusters[r]
                k = len(fi)
                cl_min[slot, :k] = mn
                cl_max[slot, :k] = mx
                cl_first[slot, :k] = fi
                cl_count[slot, :k] = cnt
                shape_cluster_row[r] = slot
            t = lambda a: torch.from_numpy(np.array(a)).to(device)
            self._device[key] = ShapeData(
                t(self.types), t(self.params), t(self.max_radius), t(self.hull_pool[:, 0]),
                t(self.hull_pool[:, 1]), t(self.hull_pool[:, 2]), t(self.hull_start),
                t(self.hull_count), t(hull_rows(self.hull_start, self.hull_count)),
                t(self.child_shape),
                t(self.child_pos), t(self.child_orn), t(self.child_tri), t(self.child_start),
                t(self.child_count), t(self.child_aabb_min), t(self.child_aabb_max),
                t(cl_min), t(cl_max), t(cl_first), t(cl_count), t(shape_cluster_row),
            )
        return self._device[key]


def inertia_from_diag(inv_mass, diag) -> tuple:
    """(inv_mass, the diagonal inverse inertia ``diag`` as a Sym3)."""
    return inv_mass, Sym3.diag(diag[0], diag[1], diag[2])
