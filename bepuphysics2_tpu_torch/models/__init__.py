"""Scene models built through the public ``Simulation`` API."""
from .ragdoll import add_ragdoll
from .scenes import build_compound_pile_sim, build_ragdoll_pile_sim, build_ragdoll_tube_sim

__all__ = ["add_ragdoll", "build_compound_pile_sim", "build_ragdoll_pile_sim",
           "build_ragdoll_tube_sim"]
