from .registry import (
    BOX,
    SHAPE_NONE,
    SPHERE,
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

__all__ = [
    "SHAPE_NONE", "SPHERE", "BOX", "ShapeData", "ShapeRegistry", "Sphere", "Box",
    "Capsule", "Triangle", "Cylinder", "ConvexHull", "Compound", "Mesh",
    "compute_body_bounds",
]
