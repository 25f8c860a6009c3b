from .vec import Mat3, Quat, Sym2, Sym3, Vec2, Vec3, build_orthonormal_basis, integrate_orientation, v3
from .spring import SpringSettings, compute_springiness

__all__ = [
    "Vec3", "Vec2", "Quat", "Mat3", "Sym3", "Sym2", "v3",
    "build_orthonormal_basis", "integrate_orientation",
    "SpringSettings", "compute_springiness",
]
