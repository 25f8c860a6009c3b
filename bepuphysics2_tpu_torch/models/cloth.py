"""Cloth lattice, the reference ClothDemo / ClothLatticeDemo (Demos/Demos/ClothDemo.cs): a
grid of small bodies linked by center-distance springs along the grid lines and across
each cell's diagonals.

``add_cloth`` is the port's copy of ``bepuphysics2_tpu/models/cloth.py``;
``build_cloth_sim`` drapes a collidable lattice over a static sphere on a static ground.
"""
from __future__ import annotations

import numpy as np

from ..bodies import BodyDescription, StaticDescription
from ..shapes import Box, Sphere
from ..simulation import SimConfig, Simulation


def add_cloth(sim, origin=(0.0, 2.0, 0.0), width: int = 8, length: int = 8,
              spacing: float = 0.25, node_mass: float = 0.05, frequency: float = 25.0,
              pin_corners: bool = True, collidable: bool = False, collision_group: int = 0):
    """A ``width`` x ``length`` lattice of nodes (spheres of radius 0.3 ``spacing``, which
    never sleep) ``spacing`` apart in x and z from ``origin``, linked to their grid
    neighbours (rest length ``spacing``) and across each cell's two diagonals, each link a
    ``center_distance`` spring of ``frequency`` Hz, critically damped. ``pin_corners``
    makes the two corners of the first row kinematic; a nonzero ``collision_group`` keeps
    the nodes from colliding with one another. Returns the (width, length) handle grid."""
    node = Sphere(spacing * 0.3)
    node_shape = sim.add_shape(node) if collidable else -1
    ox, oy, oz = origin
    grid = np.zeros((width, length), np.int32)
    for i in range(width):
        for j in range(length):
            pos = (ox + i * spacing, oy, oz + j * spacing)
            if pin_corners and i in (0, width - 1) and j == 0:
                grid[i, j] = sim.add_body(BodyDescription.kinematic(
                    pos, node_shape, collision_group=collision_group))
            else:
                grid[i, j] = sim.add_body(BodyDescription.dynamic(
                    pos, node_shape, node_mass, node, sleep_threshold=-1.0,
                    collision_group=collision_group))

    def link(a, b, dist):
        sim.add_constraint("center_distance", [int(a), int(b)], target_distance=float(dist),
                           spring_frequency=frequency, spring_damping=1.0)

    diag = spacing * np.sqrt(2.0)
    for i in range(width):
        for j in range(length):
            if i + 1 < width:
                link(grid[i, j], grid[i + 1, j], spacing)
            if j + 1 < length:
                link(grid[i, j], grid[i, j + 1], spacing)
            if i + 1 < width and j + 1 < length:
                link(grid[i, j], grid[i + 1, j + 1], diag)
                link(grid[i + 1, j], grid[i, j + 1], diag)
    return grid


def cloth_links(width: int, length: int) -> int:
    """The number of links ``add_cloth`` makes: (w-1) l + w (l-1) + 2 (w-1)(l-1)."""
    return (width - 1) * length + width * (length - 1) + 2 * (width - 1) * (length - 1)


FREQUENCY = 60.0  # build_cloth_sim's links, Hz
NODE_MASS = 0.05  # add_cloth's default


def build_cloth_sim(width: int, length: int, drop: float = 0.5, device="cuda", **overrides):
    """A collidable ``add_cloth`` lattice (spacing 0.25 m, links of ``FREQUENCY`` Hz, no
    pinned corners; its nodes point masses in one collision group, so that they touch
    only the sphere and the ground, and slide on them without rolling) centred ``drop`` m
    above a static sphere an eighth of the cloth's width across its radius, which rests on
    a static ground box (top at y = 0, twice the cloth's size each way): the middle drapes
    over the sphere as a tent and the rim lies on the ground.

    These are the settings under which a 64 x 64 lattice settles with every link within
    10% of its rest length (8.8% at most after 200 steps on the card, ``chip_smoke.py``
    phase 27; ``tools/cloth_variants.py`` holds it against spinning nodes, ``add_cloth``'s
    own, on which the drape rolls on, and against ``add_cloth``'s 25 Hz). 8 substeps, 16
    colors (an interior node has 8 links, and its contacts claim colors too) and
    ``jacobi_cap_factor`` 1.0: the coloring is incremental, and on the first steps most
    fresh links wait in the Jacobi bucket (86% of them on the first step of a 16 x 16
    lattice), which at the default 0.3 spills, in the JAX package too
    (``tools/reference_cloth.py``). ``max_pairs`` 4 per node and at least 4,096: the pair
    store keeps each color's contacts in pages of their own (128 rows below 8,192 pairs),
    and 16 colors and the Jacobi pages need 17 of them. The store admits up to one new
    pair per node a step (``store_churn``; its default, an eighth of ``max_pairs``,
    overflows while a 64 x 64 lattice lands). ``overrides`` replace config fields.
    Returns (sim, config, grid)."""
    n, spacing = width * length, 0.25
    radius = 0.125 * width * spacing
    config = SimConfig(**{**dict(
        body_capacity=n + 8, max_pairs=max(4096, 4 * n), substeps=8, num_colors=16,
        jacobi_cap_factor=1.0, joint_capacity=max(256, cloth_links(width, length)),
        store_churn=max(256, n), broadphase="auto",
    ), **overrides})
    sim = Simulation(config, device=device)
    half = 2 * max(width, length) * spacing
    sim.add_static(StaticDescription(position=(0.0, -0.5, 0.0),
                                     shape=sim.add_shape(Box(half, 0.5, half))))
    sim.add_static(StaticDescription(position=(0.0, radius, 0.0),
                                     shape=sim.add_shape(Sphere(radius))))
    origin = (-(width - 1) * spacing / 2, 2 * radius + drop, -(length - 1) * spacing / 2)
    grid = add_cloth(sim, origin=origin, width=width, length=length, spacing=spacing,
                     node_mass=NODE_MASS, frequency=FREQUENCY, pin_corners=False,
                     collidable=True, collision_group=sim.new_collision_group())
    for h in grid.reshape(-1):  # point masses: the nodes slide, they do not roll
        sim.set_local_inertia(int(h), 1.0 / NODE_MASS, (0.0,) * 6)
    return sim, config, grid
