"""bepuphysics2_tpu_torch — the PyTorch/CUDA port of ``bepuphysics2_tpu``.

The same ``Simulation`` / ``SimConfig`` API and step stages as the JAX package, on torch
tensors: bounds, brute-force broad phase, persistent pair store, narrow phase, the
substepped TGS contact solve (kernel K1, hand-written CUDA for sm_90a, on a CUDA device;
its plain PyTorch version on the CPU) and island sleep. Every entry point takes an
explicit ``device``. The port carries sphere and box scenes on the pair-store path.
"""

__version__ = "0.1.0"

from .utils.vec import Vec3, Quat, Mat3, Sym3, v3
from .bodies import (
    BodyDescription,
    StaticDescription,
    KIND_DYNAMIC,
    KIND_KINEMATIC,
    KIND_STATIC,
)
from .shapes import Sphere, Box, Capsule, Cylinder, Triangle, ConvexHull, Compound, Mesh
from .simulation import Simulation, SimConfig

__all__ = [
    "Vec3", "Quat", "Mat3", "Sym3", "v3",
    "BodyDescription", "StaticDescription",
    "KIND_DYNAMIC", "KIND_KINEMATIC", "KIND_STATIC",
    "Sphere", "Box", "Capsule", "Cylinder", "Triangle", "ConvexHull", "Compound", "Mesh",
    "Simulation", "SimConfig",
]
