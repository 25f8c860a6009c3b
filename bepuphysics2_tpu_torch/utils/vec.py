"""Component-wise SoA math types over torch tensors.

The PyTorch counterpart of ``bepuphysics2_tpu/utils/vec.py``: each component is a plain
float32 tensor of any shape, and every op broadcasts, so the same types serve scalars,
per-body ``(N,)`` arrays and per-contact ``(N, 4)`` arrays. The formulas (and their
operation order) follow the JAX module one for one, so both packages round alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """3-vector with each component an arbitrary-shape tensor (SoA layout)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def zeros(shape=(), dtype=torch.float32, device=None) -> "Vec3":
        return Vec3(*(torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)))

    @staticmethod
    def full(shape, vx, vy, vz, dtype=torch.float32, device=None) -> "Vec3":
        return Vec3(
            torch.full(shape, vx, dtype=dtype, device=device),
            torch.full(shape, vy, dtype=dtype, device=device),
            torch.full(shape, vz, dtype=dtype, device=device),
        )

    @staticmethod
    def from_array(a) -> "Vec3":
        """From a trailing-dim-3 tensor ``(..., 3)``."""
        a = torch.as_tensor(a, dtype=torch.float32)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def distance(self, o: "Vec3") -> torch.Tensor:
        return (self - o).length()

    def normalize(self, eps: float = 1e-15) -> "Vec3":
        ln = self.length()
        inv = torch.where(ln > eps, 1.0 / ln.clamp_min(eps), 0.0)
        return self * inv

    def min(self, o: "Vec3") -> "Vec3":
        return Vec3(torch.minimum(self.x, o.x), torch.minimum(self.y, o.y), torch.minimum(self.z, o.z))

    def max(self, o: "Vec3") -> "Vec3":
        return Vec3(torch.maximum(self.x, o.x), torch.maximum(self.y, o.y), torch.maximum(self.z, o.z))

    def abs(self) -> "Vec3":
        return Vec3(self.x.abs(), self.y.abs(), self.z.abs())

    def where(self, mask, other: "Vec3") -> "Vec3":
        """Select self where mask else other (component-wise broadcast)."""
        return Vec3(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
        )

    def __getitem__(self, idx) -> "Vec3":
        # Tensor indexing of every component (fields stay reachable as .x/.y/.z).
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def sum(self, axis=None) -> "Vec3":
        if axis is None:
            return Vec3(self.x.sum(), self.y.sum(), self.z.sum())
        return Vec3(self.x.sum(axis), self.y.sum(axis), self.z.sum(axis))


def v3(x, y, z) -> Vec3:
    """Literal Vec3 of scalars/tensors."""
    f = lambda c: torch.as_tensor(c, dtype=torch.float32)
    return Vec3(f(x), f(y), f(z))


class Vec2(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor

    @staticmethod
    def zeros(shape=(), dtype=torch.float32, device=None) -> "Vec2":
        return Vec2(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))

    def __add__(self, o):
        return Vec2(self.x + o.x, self.y + o.y)

    def __sub__(self, o):
        return Vec2(self.x - o.x, self.y - o.y)

    def __mul__(self, s):
        return Vec2(self.x * s, self.y * s)

    __rmul__ = __mul__

    def dot(self, o):
        return self.x * o.x + self.y * o.y

    def length(self):
        return torch.sqrt(self.dot(self))


class Mat3(NamedTuple):
    """Row-major 3x3 matrix as three Vec3 rows, in the reference's row-vector convention:
    ``transform(v) = v.x * rx + v.y * ry + v.z * rz``."""

    rx: Vec3
    ry: Vec3
    rz: Vec3

    def transform(self, v: Vec3) -> Vec3:
        return Vec3(
            v.x * self.rx.x + v.y * self.ry.x + v.z * self.rz.x,
            v.x * self.rx.y + v.y * self.ry.y + v.z * self.rz.y,
            v.x * self.rx.z + v.y * self.ry.z + v.z * self.rz.z,
        )

    def transform_transpose(self, v: Vec3) -> Vec3:
        return Vec3(self.rx.dot(v), self.ry.dot(v), self.rz.dot(v))

    def transpose(self) -> "Mat3":
        return Mat3(
            Vec3(self.rx.x, self.ry.x, self.rz.x),
            Vec3(self.rx.y, self.ry.y, self.rz.y),
            Vec3(self.rx.z, self.ry.z, self.rz.z),
        )

    def matmul(self, o: "Mat3") -> "Mat3":
        return Mat3(o.transform(self.rx), o.transform(self.ry), o.transform(self.rz))

    def __add__(self, o: "Mat3") -> "Mat3":
        return Mat3(self.rx + o.rx, self.ry + o.ry, self.rz + o.rz)

    def __sub__(self, o: "Mat3") -> "Mat3":
        return Mat3(self.rx - o.rx, self.ry - o.ry, self.rz - o.rz)

    def __mul__(self, s) -> "Mat3":
        return Mat3(self.rx * s, self.ry * s, self.rz * s)

    __rmul__ = __mul__

    def determinant(self) -> torch.Tensor:
        return self.rx.dot(self.ry.cross(self.rz))

    def inverse(self, eps: float = 0.0) -> "Mat3":
        """Inverse via adjugate (same layout as the JAX Mat3.inverse)."""
        c0 = self.ry.cross(self.rz)
        c1 = self.rz.cross(self.rx)
        c2 = self.rx.cross(self.ry)
        det = self.rx.dot(c0)
        inv_det = torch.where(det.abs() > eps, 1.0 / det, 0.0)
        return Mat3(
            Vec3(c0.x, c1.x, c2.x) * inv_det,
            Vec3(c0.y, c1.y, c2.y) * inv_det,
            Vec3(c0.z, c1.z, c2.z) * inv_det,
        )

    @staticmethod
    def identity(shape=(), device=None) -> "Mat3":
        one = lambda: torch.ones(shape, dtype=torch.float32, device=device)
        zero = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
        return Mat3(Vec3(one(), zero(), zero()), Vec3(zero(), one(), zero()),
                    Vec3(zero(), zero(), one()))

    @staticmethod
    def cross_matrix(v: Vec3) -> "Mat3":
        """Reference Matrix3x3.CreateCrossProduct: ``w M == v × w`` in the row convention."""
        zero = torch.zeros_like(v.x)
        return Mat3(
            Vec3(zero, v.z, -v.y),
            Vec3(-v.z, zero, v.x),
            Vec3(v.y, -v.x, zero),
        )


class Sym3(NamedTuple):
    """Symmetric 3x3 matrix, lower triangle (xx, yx, yy, zx, zy, zz)."""

    xx: torch.Tensor
    yx: torch.Tensor
    yy: torch.Tensor
    zx: torch.Tensor
    zy: torch.Tensor
    zz: torch.Tensor

    @staticmethod
    def zeros(shape=(), dtype=torch.float32, device=None) -> "Sym3":
        return Sym3(*(torch.zeros(shape, dtype=dtype, device=device) for _ in range(6)))

    @staticmethod
    def diag(x, y, z) -> "Sym3":
        x = torch.as_tensor(x, dtype=torch.float32)
        zero = torch.zeros_like(x)
        return Sym3(x, zero, torch.as_tensor(y, dtype=torch.float32), zero, zero,
                    torch.as_tensor(z, dtype=torch.float32))

    @staticmethod
    def identity(shape=(), device=None) -> "Sym3":
        one = torch.ones(shape, dtype=torch.float32, device=device)
        return Sym3.diag(one, one, one)

    def __add__(self, o: "Sym3") -> "Sym3":
        return Sym3(*(a + b for a, b in zip(self, o)))

    def __mul__(self, s) -> "Sym3":
        return Sym3(*(a * s for a in self))

    __rmul__ = __mul__

    def transform(self, v: Vec3) -> Vec3:
        return Vec3(
            v.x * self.xx + v.y * self.yx + v.z * self.zx,
            v.x * self.yx + v.y * self.yy + v.z * self.zy,
            v.x * self.zx + v.y * self.zy + v.z * self.zz,
        )

    def vector_sandwich(self, v: Vec3) -> torch.Tensor:
        return v.dot(self.transform(v))

    def determinant(self) -> torch.Tensor:
        m11 = self.yy * self.zz - self.zy * self.zy
        m21 = self.zy * self.zx - self.zz * self.yx
        m31 = self.yx * self.zy - self.zx * self.yy
        return m11 * self.xx + m21 * self.yx + m31 * self.zx

    def inverse(self, eps: float = 0.0) -> "Sym3":
        """Symmetric inverse; a (near-)zero determinant inverts to zeros."""
        m11 = self.yy * self.zz - self.zy * self.zy
        m21 = self.zy * self.zx - self.zz * self.yx
        m31 = self.yx * self.zy - self.zx * self.yy
        det = m11 * self.xx + m21 * self.yx + m31 * self.zx
        inv = torch.where(det.abs() > eps, 1.0 / det, 0.0)
        m22 = self.zz * self.xx - self.zx * self.zx
        m32 = self.zx * self.yx - self.xx * self.zy
        m33 = self.xx * self.yy - self.yx * self.yx
        return Sym3(m11 * inv, m21 * inv, m22 * inv, m31 * inv, m32 * inv, m33 * inv)

    def rotation_sandwich(self, r: Mat3) -> "Sym3":
        """R^T · S · R in the reference row convention (world inverse inertia)."""
        ixx = r.rx.x * self.xx + r.ry.x * self.yx + r.rz.x * self.zx
        ixy = r.rx.x * self.yx + r.ry.x * self.yy + r.rz.x * self.zy
        ixz = r.rx.x * self.zx + r.ry.x * self.zy + r.rz.x * self.zz
        iyx = r.rx.y * self.xx + r.ry.y * self.yx + r.rz.y * self.zx
        iyy = r.rx.y * self.yx + r.ry.y * self.yy + r.rz.y * self.zy
        iyz = r.rx.y * self.zx + r.ry.y * self.zy + r.rz.y * self.zz
        izx = r.rx.z * self.xx + r.ry.z * self.yx + r.rz.z * self.zx
        izy = r.rx.z * self.yx + r.ry.z * self.yy + r.rz.z * self.zy
        izz = r.rx.z * self.zx + r.ry.z * self.zy + r.rz.z * self.zz
        return Sym3(
            ixx * r.rx.x + ixy * r.ry.x + ixz * r.rz.x,
            iyx * r.rx.x + iyy * r.ry.x + iyz * r.rz.x,
            iyx * r.rx.y + iyy * r.ry.y + iyz * r.rz.y,
            izx * r.rx.x + izy * r.ry.x + izz * r.rz.x,
            izx * r.rx.y + izy * r.ry.y + izz * r.rz.y,
            izx * r.rx.z + izy * r.ry.z + izz * r.rz.z,
        )

    def skew_sandwich(self, r: Vec3) -> "Sym3":
        """K = skew(r) · S · skew(r)^T; K_ij = (e_i × r) · S · (e_j × r)."""
        z = torch.zeros_like(r.x)
        ux = Vec3(z, -r.z, r.y)
        uy = Vec3(r.z, z, -r.x)
        uz = Vec3(-r.y, r.x, z)
        sux = self.transform(ux)
        suy = self.transform(uy)
        suz = self.transform(uz)
        return Sym3(ux.dot(sux), uy.dot(sux), uy.dot(suy), uz.dot(sux), uz.dot(suy), uz.dot(suz))

    def where(self, mask, other: "Sym3") -> "Sym3":
        return Sym3(*(torch.where(mask, a, b) for a, b in zip(self, other)))

    def __getitem__(self, idx) -> "Sym3":
        return Sym3(*(c[idx] for c in (self.xx, self.yx, self.yy, self.zx, self.zy, self.zz)))

    def to_matrix(self) -> torch.Tensor:
        """Dense (..., 3, 3) tensor (for tests / interop)."""
        row0 = torch.stack([self.xx, self.yx, self.zx], -1)
        row1 = torch.stack([self.yx, self.yy, self.zy], -1)
        row2 = torch.stack([self.zx, self.zy, self.zz], -1)
        return torch.stack([row0, row1, row2], -2)


class Sym2(NamedTuple):
    """Symmetric 2x2 (xx, yx, yy) for the tangent-friction effective mass."""

    xx: torch.Tensor
    yx: torch.Tensor
    yy: torch.Tensor

    def __add__(self, o: "Sym2") -> "Sym2":
        return Sym2(self.xx + o.xx, self.yx + o.yx, self.yy + o.yy)

    def transform(self, v: Vec2) -> Vec2:
        return Vec2(v.x * self.xx + v.y * self.yx, v.x * self.yx + v.y * self.yy)

    def inverse(self) -> "Sym2":
        det = self.xx * self.yy - self.yx * self.yx
        inv = torch.where(det.abs() > 0, 1.0 / det, 0.0)
        return Sym2(self.yy * inv, -self.yx * inv, self.xx * inv)


class Quat(NamedTuple):
    """Quaternion (x, y, z, w), the reference's (System.Numerics) component order."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor

    @staticmethod
    def identity(shape=(), device=None) -> "Quat":
        z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
        return Quat(z(), z(), z(), torch.ones(shape, dtype=torch.float32, device=device))

    @staticmethod
    def from_array(a) -> "Quat":
        a = torch.as_tensor(a, dtype=torch.float32)
        return Quat(a[..., 0], a[..., 1], a[..., 2], a[..., 3])

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z, self.w], dim=-1)

    @staticmethod
    def from_axis_angle(axis: Vec3, angle) -> "Quat":
        half = torch.as_tensor(angle, dtype=torch.float32) * 0.5
        s = torch.sin(half)
        return Quat(axis.x * s, axis.y * s, axis.z * s, torch.cos(half))

    def mul(self, b: "Quat") -> "Quat":
        """Hamilton product self * b (rotate by b, then by self)."""
        a = self
        return Quat(
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
            a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
        )

    def conjugate(self) -> "Quat":
        return Quat(-self.x, -self.y, -self.z, self.w)

    def normalize(self) -> "Quat":
        inv = 1.0 / torch.sqrt(self.x * self.x + self.y * self.y + self.z * self.z
                               + self.w * self.w)
        return Quat(self.x * inv, self.y * inv, self.z * inv, self.w * inv)

    def rotate(self, v: Vec3) -> Vec3:
        """q v q*: t = 2 (q.xyz × v); v' = v + w t + q.xyz × t."""
        qv = Vec3(self.x, self.y, self.z)
        t = qv.cross(v) * 2.0
        return v + t * self.w + qv.cross(t)

    def rotate_inverse(self, v: Vec3) -> Vec3:
        return self.conjugate().rotate(v)

    def to_matrix(self) -> Mat3:
        """Rotation matrix with ``m.transform(v) == self.rotate(v)``."""
        x2 = self.x + self.x
        y2 = self.y + self.y
        z2 = self.z + self.z
        xx2 = self.x * x2
        yy2 = self.y * y2
        zz2 = self.z * z2
        xy2 = self.x * y2
        xz2 = self.x * z2
        yz2 = self.y * z2
        wx2 = self.w * x2
        wy2 = self.w * y2
        wz2 = self.w * z2
        return Mat3(
            Vec3(1.0 - yy2 - zz2, xy2 + wz2, xz2 - wy2),
            Vec3(xy2 - wz2, 1.0 - xx2 - zz2, yz2 + wx2),
            Vec3(xz2 + wy2, yz2 - wx2, 1.0 - xx2 - yy2),
        )

    def where(self, mask, other: "Quat") -> "Quat":
        return Quat(*(torch.where(mask, a, b) for a, b in zip(self, other)))

    def __getitem__(self, idx) -> "Quat":
        return Quat(self.x[idx], self.y[idx], self.z[idx], self.w[idx])


def integrate_orientation(orn: Quat, omega: Vec3, dt) -> Quat:
    """Piecewise-linear orientation integration (reference PoseIntegrator.cs:122-143):
    q' = normalize(axis_angle(ω̂, |ω| dt) ⊗ q), identity when |ω| ~ 0."""
    speed = omega.length()
    half_angle = speed * dt * 0.5
    scale = torch.where(speed > 1e-15, torch.sin(half_angle) / speed.clamp_min(1e-15), 0.0)
    dq = Quat(omega.x * scale, omega.y * scale, omega.z * scale, torch.cos(half_angle))
    integrated = dq.mul(orn).normalize()
    return integrated.where(speed > 1e-15, orn)


def build_orthonormal_basis(normal: Vec3):
    """Branch-free tangent basis (t1, t2) ⟂ a unit normal (reference Helpers.cs:21-35)."""
    sign = torch.where(normal.z < 0.0, -1.0, 1.0).to(normal.z.dtype)
    scale = -1.0 / (sign + normal.z)
    t1 = Vec3(normal.x * normal.y * scale, sign + normal.y * normal.y * scale, -normal.y)
    t2 = Vec3(1.0 + sign * normal.x * normal.x * scale, sign * t1.x, -sign * normal.x)
    return t1, t2
