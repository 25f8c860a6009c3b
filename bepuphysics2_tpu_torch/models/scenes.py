"""Scene builders of the benchmark scenarios, the port's own copies of
``__graft_entry__._build_ragdoll_tube_sim``."""
from __future__ import annotations

import numpy as np

from ..bodies import BodyDescription
from ..shapes import Box, Compound
from ..simulation import SimConfig, Simulation
from .ragdoll import add_ragdoll


def build_ragdoll_tube_sim(n_ragdolls: int, substeps: int = 4, num_colors: int = 8,
                           device="cuda"):
    """RagdollTubeBenchmark analogue (reference DemoBenchmarks/RagdollTubeBenchmark.cs:17):
    ragdolls (10 bodies, 18 joints each) lined up along the axis (z) of a kinematic tube
    of 24 box panels, radius 4.5, spinning at 1 rad/s. Returns (sim, config)."""
    n_bodies = 10 * n_ragdolls + 8
    config = SimConfig(
        body_capacity=n_bodies + 8,
        max_pairs=max(1024, 8 * n_bodies),
        max_compound_pairs=max(256, 2 * n_bodies),
        children_per_pair=8,
        substeps=substeps,
        num_colors=num_colors,
        broadphase="auto",
        joint_capacity=max(256, 16 * n_ragdolls),
        shape_capacity=max(256, 8 * n_ragdolls + 64),
    )
    sim = Simulation(config, device=device)
    radius, n_panels = 4.5, 24
    length = max(8.0, 2.2 * n_ragdolls + 4.0)
    panel_w = 2 * np.pi * radius / n_panels * 0.62  # slight overlap
    box_id = sim.add_shape(Box(panel_w * 0.5, 0.25, length * 0.5))
    children = []
    for k in range(n_panels):
        th = 2 * np.pi * k / n_panels
        # Rotation about z by th, so the panel's local +y is the radial direction.
        q = (0.0, 0.0, float(np.sin(th * 0.5)), float(np.cos(th * 0.5)))
        children.append((box_id, (radius * -np.sin(th), radius * np.cos(th), 0.0), q))
    tube_shape = sim.add_shape(Compound.build(children))
    tube = sim.add_body(BodyDescription.kinematic((0.0, 6.0, 0.0), tube_shape))
    sim.set_velocity(tube, angular=(0.0, 0.0, 1.0))
    for k in range(n_ragdolls):
        add_ragdoll(sim, position=(0.0, 5.2, -length * 0.5 + 2.0 + 2.2 * k))
    return sim, config
