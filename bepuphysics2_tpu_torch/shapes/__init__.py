from .registry import (
    BIG_COMPOUND,
    BOX,
    CAPSULE,
    COMPOUND,
    CONVEX_HULL,
    CYLINDER,
    MESH,
    SHAPE_NONE,
    SPHERE,
    TRIANGLE,
    Box,
    Capsule,
    Compound,
    ConvexHull,
    Cylinder,
    Mesh,
    ShapeData,
    ShapeRegistry,
    Sphere,
    Triangle,
)
from .bounds import compute_body_bounds
from .builder import CompoundBuilder
from .custom import CustomShape, is_custom, register_custom_shape

__all__ = [
    "SHAPE_NONE", "SPHERE", "CAPSULE", "BOX", "TRIANGLE", "CYLINDER", "CONVEX_HULL", "COMPOUND",
    "BIG_COMPOUND", "MESH", "CompoundBuilder",
    "ShapeData", "ShapeRegistry", "Sphere", "Box", "Capsule", "Triangle", "Cylinder",
    "ConvexHull", "Compound", "Mesh", "CustomShape", "register_custom_shape", "is_custom",
    "compute_body_bounds",
]
