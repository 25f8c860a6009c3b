"""bepuphysics2_tpu_torch — the PyTorch/CUDA port of ``bepuphysics2_tpu``.

The same ``Simulation`` / ``SimConfig`` API and step stages as the JAX package, on torch
tensors: bounds, broad phase (brute force, or grid2 above 8,192 bodies), persistent pair
store, narrow phase (with compound children), the substepped TGS solve (kernel K1, or the
windowed kernel K2 above 8,192 bodies, for store-only scenes; the general path over
kernel K3 for scenes with joints, or K4 above 8,192 bodies: hand-written CUDA for sm_90a
on a CUDA device, their plain PyTorch versions on the CPU), island sleep, and
demand-driven ``autosize``. A ``Simulation`` runs on the CUDA card unless it is given
``device="cpu"``. The port carries sphere, capsule, box, triangle, cylinder, convex hull
and custom convex shapes (the last three over the generic GJK/MPR narrow phase),
compounds of them and triangle meshes (compound-vs-compound pairs with ``max_cc_pairs``),
all 30 joint types of the reference, the scene queries (ray casts, sweeps, box queries,
contact events; their conservative advancement in kernel K8), continuous collision
detection (``max_ccd_pairs``, over K8), checkpoints, metrics, validation and stage
profiling, and ``models``: the ragdoll, the colosseum, the cloth, the car, the tank and
the character. The TPU design probes of the repository's ``experiments/`` run in
``experiments`` (kernels K5-K7).
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
from .shapes.builder import CompoundBuilder
from .shapes.custom import CustomShape, register_custom_shape
from .simulation import Simulation, SimConfig
from .validation import validate
from .metrics import SimMetrics, simulation_metrics, TraceSession

__all__ = [
    "Vec3", "Quat", "Mat3", "Sym3", "v3",
    "BodyDescription", "StaticDescription",
    "KIND_DYNAMIC", "KIND_KINEMATIC", "KIND_STATIC",
    "Sphere", "Box", "Capsule", "Cylinder", "Triangle", "ConvexHull", "Compound", "Mesh",
    "CompoundBuilder", "CustomShape", "register_custom_shape",
    "Simulation", "SimConfig", "validate",
    "SimMetrics", "simulation_metrics", "TraceSession",
]
