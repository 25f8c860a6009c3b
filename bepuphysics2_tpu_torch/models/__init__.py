"""Scene models built through the public ``Simulation`` API."""
from .character import Character
from .cloth import add_cloth, build_cloth_sim
from .ragdoll import add_ragdoll
from .scenes import (
    awake_fraction, build_colosseum_sim, build_compound_pile_sim, build_ragdoll_pile_sim,
    build_ragdoll_tube_sim, build_terrain_pile_sim, run_colosseum, terrain_height, terrain_mesh,
)
from .tank import Tank
from .vehicle import SimpleCar

__all__ = ["Character", "add_cloth", "add_ragdoll", "awake_fraction", "build_cloth_sim",
           "build_colosseum_sim", "build_compound_pile_sim", "build_ragdoll_pile_sim",
           "build_ragdoll_tube_sim", "build_terrain_pile_sim", "run_colosseum",
           "terrain_height", "terrain_mesh", "SimpleCar", "Tank"]
