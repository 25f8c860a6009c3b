"""Scene builders: the port's own copies of ``__graft_entry__._build_ragdoll_tube_sim`` and
``_build_colosseum_sim`` (with ``run_colosseum``, ``bench.py``'s colosseum sequence), and
two scenes built from the same parts, the ragdoll pile (the general solve above 8,192
bodies) and the compound pile (a contact-only scene with a compound bank)."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..bodies import KIND_DYNAMIC, BodyDescription, StaticDescription
from ..shapes import Box, Compound, CompoundBuilder, Mesh, Sphere
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
    length = max(8.0, 2.2 * n_ragdolls + 4.0)
    _add_tube(sim, length)
    for k in range(n_ragdolls):
        add_ragdoll(sim, position=(0.0, 5.2, -length * 0.5 + 2.0 + 2.2 * k))
    return sim, config


def _add_tube(sim, length: float):
    """The tube: a kinematic compound of 24 box panels around a radius-4.5 circle about
    the z axis through (0, 6, 0), spinning at 1 rad/s."""
    radius, n_panels = 4.5, 24
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


def ragdoll_pile_positions(n_ragdolls: int, layer=(16, 16), seed: int = 0):
    """(n, 3) standing positions of the ragdoll pile: layers of ``layer`` = (nx, nz)
    ragdolls, 2.0 m apart in x and 1.0 m in z with +-0.05 m of seeded jitter in x and z,
    layers 2.2 m apart, the lowest 0.3 m above the ground."""
    nx, nz = layer
    k = np.arange(n_ragdolls)
    jit = np.random.default_rng(seed).uniform(-0.05, 0.05, (n_ragdolls, 2))
    ix, iz, iy = k % nx, (k // nx) % nz, k // (nx * nz)
    return np.stack([(ix - (nx - 1) / 2) * 2.0 + jit[:, 0], 0.3 + 2.2 * iy,
                     (iz - (nz - 1) / 2) * 1.0 + jit[:, 1]], -1)


def ragdoll_pile_config(n_ragdolls: int, substeps: int = 4, num_colors: int = 16) -> dict:
    """The ragdoll pile's ``SimConfig`` fields (``build_ragdoll_pile_sim``)."""
    n_bodies = 10 * n_ragdolls + 8
    return dict(  # max_pairs in whole 512-row pages: the windowed slices are 256 rows
        body_capacity=n_bodies + 8, max_pairs=max(1024, -(-16 * n_bodies // 512) * 512),
        wide_cap_rows=4 * n_bodies, grid_cell_capacity=128, grid_pair_k=64,
        substeps=substeps, num_colors=num_colors, jacobi_cap_factor=0.6,
        joint_capacity=max(256, 16 * n_ragdolls), shape_capacity=max(256, 8 * n_ragdolls + 64))


def build_ragdoll_pile_sim(n_ragdolls: int, substeps: int = 4, num_colors: int = 16,
                           seed: int = 0, layer=(16, 16), device="cuda", **overrides):
    """The ragdoll pile: ``n_ragdolls`` ragdolls (10 bodies, 18 joints each: the reference
    RagdollDemo) standing in layers (``ragdoll_pile_positions``) over a static ground box
    of half extents (100, 0.5, 100) with its top at y = 0. Joint and shape capacities
    follow the tube builder's formulas. The pair capacities are sized for the step where
    the top layer lands, the pile's peak (at 1,024 ragdolls: 9.6 candidate pairs, 1.5
    admissions and 2.0 windowed wide rows per body, and more than 64 entries in a grid
    cell): ``max_pairs`` 16 per body, ``wide_cap_rows`` 4 per body, grid cell capacity
    128 and 64 large partners per body. Below that the broad phase drops pairs, the
    ground's first (large-body pairs come last), and limbs land through the ground
    (``tools/pile_landing.py`` prints the landing step by step). The solver settings are
    the package's defaults but for ``jacobi_cap_factor``, 0.6 instead of 0.3: the first
    step's coloring leaves 10 of each ragdoll's 18 fresh joints to the Jacobi bucket, and
    at 0.3 the bucket spills and the limbs fly apart, in the JAX package too
    (``tools/reference_pile.py``). Above 8,192 body slots (820 ragdolls) the
    grid2 broad phase and the windowed layout run, and the store solves through K4.
    ``overrides`` replace config fields. Returns (sim, config)."""
    config = SimConfig(**{**ragdoll_pile_config(n_ragdolls, substeps, num_colors),
                          **overrides})
    sim = Simulation(config, device=device)
    ground = sim.add_shape(Box(100.0, 0.5, 100.0))
    sim.add_static(StaticDescription(position=(0.0, -0.5, 0.0), shape=ground))
    for p in ragdoll_pile_positions(n_ragdolls, layer, seed):
        add_ragdoll(sim, position=tuple(float(c) for c in p))
    return sim, config


def compound_pile_positions(n_bodies: int):
    """(n, 3) positions of the compound pile's bodies: layers of 3 x 3 just above the
    bottom of the tube (its inner face is 4.25 m below the axis), 1.0 m apart across it
    and along it and 0.8 m apart in height."""
    k = np.arange(n_bodies)
    return np.stack([(k % 3 - 1) * 1.0, 2.3 + (k // 3 % 3) * 0.8,
                     -(n_bodies // 9) * 0.5 + (k // 9) * 1.0], -1)


def build_compound_pile_sim(n_bodies: int, substeps: int = 4, num_colors: int = 8,
                            device="cuda"):
    """The compound pile: the ragdoll tube's spinning kinematic compound tube holding
    ``n_bodies`` alternating spheres (radius 0.3) and boxes (half extent 0.3) in place of
    the ragdolls, and no joints: a contact-only scene with a compound bank, which solves
    in one K1 launch per step over the store's and the compound's banks. Capacities follow
    the tube builder's formulas. Returns (sim, config)."""
    n_slots = n_bodies + 8
    config = SimConfig(
        body_capacity=n_slots + 8, max_pairs=max(1024, 8 * n_slots),
        max_compound_pairs=max(256, 2 * n_slots), children_per_pair=8, substeps=substeps,
        num_colors=num_colors,
    )
    sim = Simulation(config, device=device)
    _add_tube(sim, max(8.0, (n_bodies // 9) * 1.0 + 4.0))
    sphere, box = Sphere(0.3), Box(0.3, 0.3, 0.3)
    sphere_id, box_id = sim.add_shape(sphere), sim.add_shape(box)
    for i, p in enumerate(compound_pile_positions(n_bodies)):
        sid, obj = (sphere_id, sphere) if i % 2 == 0 else (box_id, box)
        sim.add_body(BodyDescription.dynamic(tuple(float(c) for c in p), sid, 1.0, obj))
    return sim, config


def terrain_height(x, z):
    """The terrain's surface: y = 0.5 sin(x/4) cos(z/4)."""
    return 0.5 * np.sin(np.asarray(x) / 4.0) * np.cos(np.asarray(z) / 4.0)


def terrain_mesh(cells: int, cell: float = 2.0) -> Mesh:
    """A static height field of cells x cells squares of side ``cell``, centred on the
    origin, two upward-wound triangles each (2 x cells² triangles)."""
    lo = -0.5 * cells * cell
    g = lo + cell * np.arange(cells + 1)
    y = terrain_height(g[:, None], g[None, :])
    tris = []
    for i in range(cells):
        for j in range(cells):
            a, b = (g[i], y[i, j], g[j]), (g[i], y[i, j + 1], g[j + 1])
            c, d = (g[i + 1], y[i + 1, j], g[j]), (g[i + 1], y[i + 1, j + 1], g[j + 1])
            tris += [(a, b, c), (c, b, d)]
    return Mesh.build(tris)


def build_terrain_pile_sim(n_bodies: int, cells: int, cell: float = 2.0, substeps: int = 4,
                           num_colors: int = 8, device="cuda", **overrides):
    """``n_bodies`` dynamic bodies dropped on a static ``terrain_mesh(cells, cell)``:
    spheres (radius 0.5), boxes (half extent 0.5) and, one body in eight, a dumbbell (a
    compound of two boxes of half extent 0.3, its inertia from ``CompoundBuilder``; its
    records with the mesh rest on the port's repair of ``conv_is_a``, ROADMAP queue 3),
    in a
    square grid 1.5 m above the surface (seed 3). Brute-force broad phase; the mesh makes
    every body a compound pair, and a dumbbell on the mesh a compound-vs-compound pair
    (``max_cc_pairs``). A triangle is 2 m on a side, so no body overlaps more than 8
    triangles: ``children_per_pair`` 8, ``cc_children_per_side`` 8. ``child_window`` 1,024
    (64 clusters a pair): the registry's Morton clusters of a height field interleave the
    height's bits with the others', so on 60 x 60 cells a cluster of 16 triangles spans a
    median 26 m and a body's bounding sphere meets up to 37 of them (16.6 on average;
    at the default 128, 8 clusters, the expansion overflows and bodies fall through, in
    the JAX package too: ROADMAP queue 3). The other capacities start at 8 pairs and 2
    compound pairs per body and are meant for ``autosize``. Returns (sim, config)."""
    config = SimConfig(**{**dict(
        body_capacity=n_bodies + 64, max_pairs=max(8 * n_bodies, 4096), substeps=substeps,
        num_colors=num_colors, broadphase="brute", max_compound_pairs=max(256, 2 * n_bodies),
        children_per_pair=8, child_window=1024, max_cc_pairs=max(64, n_bodies // 4),
        cc_children_per_side=8,
    ), **overrides})
    sim = Simulation(config, device=device)
    sim.add_static(StaticDescription(position=(0.0, 0.0, 0.0),
                                     shape=sim.add_shape(terrain_mesh(cells, cell))))
    sphere, box = Sphere(0.5), Box(0.5, 0.5, 0.5)
    sphere_id, box_id = sim.add_shape(sphere), sim.add_shape(box)
    builder = CompoundBuilder(sim)
    half = Box(0.3, 0.3, 0.3)
    builder.add(half, (-0.4, 0.0, 0.0), 0.5).add(half, (0.4, 0.0, 0.0), 0.5)
    children, dumb_inv_mass, dumb_inertia, _ = builder.build()
    dumbbell_id = sim.add_shape(Compound.build(children))
    side = int(np.ceil(np.sqrt(n_bodies)))
    span = 0.9 * cells * cell
    rng = np.random.default_rng(3)
    for i in range(n_bodies):
        x = (i % side + 0.5) / side * span - 0.5 * span + rng.uniform(-0.1, 0.1)
        z = (i // side + 0.5) / side * span - 0.5 * span + rng.uniform(-0.1, 0.1)
        p = (float(x), float(terrain_height(x, z) + 1.5 + rng.uniform(0.0, 0.3)), float(z))
        if i % 8 == 7:
            sim.add_body(BodyDescription(position=p, shape=dumbbell_id, inv_mass=dumb_inv_mass,
                                         inv_inertia=dumb_inertia, kind=KIND_DYNAMIC))
        else:
            sid, obj = (sphere_id, sphere) if i % 2 == 0 else (box_id, box)
            sim.add_body(BodyDescription.dynamic(p, sid, 1.0, obj))
    return sim, config


def build_colosseum_sim(n_bodies: int, substeps: int = 4, num_colors: int = 8,
                        ring_count: int = 48, layers: int = 15, enable_sleep: bool = True,
                        device="cuda", **overrides):
    """The colosseum (reference Demos/ColosseumDemo.cs and PyramidDemo.cs): a square grid of
    ``n_bodies // (ring_count * layers)`` colosseums (at least one), each a ring of
    ``ring_count`` bricks of half extents (1.0, 0.5, 0.5) stacked ``layers`` high in a
    brick pattern (odd layers turned by half a brick), 5% tangential slack and a 2 mm gap
    between layers, colosseum centers ``2.6 * radius`` apart, on a static ground box that
    covers the grid. Once settled its islands sleep; toppling one colosseum wakes it alone.
    ``max_pairs`` is 4 per body (at least 4,096), rounded up to whole 512-row pages above
    8,192 body slots, where the windowed layout runs in 256-row slices. ``overrides``
    replace config fields. Returns (sim, config, handles, colosseum index per body)."""
    per_col = ring_count * layers
    n_cols = max(1, n_bodies // per_col)
    grid = int(np.ceil(np.sqrt(n_cols)))
    bw, bh, bd = 1.0, 0.5, 0.5
    spacing = 2.0 * bw * 1.05
    radius = ring_count * spacing / (2 * np.pi)
    pitch = 2.6 * radius
    capacity = n_cols * per_col + 64
    max_pairs = max(4096, 4 * n_cols * per_col)
    if capacity > 8192:
        max_pairs = -(-max_pairs // 512) * 512
    config = SimConfig(**{**dict(body_capacity=capacity, max_pairs=max_pairs,
                                 substeps=substeps, num_colors=num_colors, broadphase="auto",
                                 enable_sleep=enable_sleep), **overrides})
    sim = Simulation(config, device=device)
    world = grid * pitch + 4 * radius
    ground = sim.add_shape(Box(world, 0.5, world))  # top face at y = 0
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    box = Box(bw, bh, bd)
    box_id = sim.add_shape(box)
    handles, col_of = [], []
    for c in range(n_cols):
        cx = (c % grid - (grid - 1) / 2) * pitch
        cz = (c // grid - (grid - 1) / 2) * pitch
        for ly in range(layers):
            y = bh + ly * (2.0 * bh + 0.002)
            off = (0.5 / ring_count) * (ly % 2)
            for k in range(ring_count):
                th = 2 * np.pi * (k / ring_count + off)
                # The brick's long axis along the ring's tangent: R_y(-(th + pi/2)).
                half = -(th + np.pi / 2) * 0.5
                q = (0.0, float(np.sin(half)), 0.0, float(np.cos(half)))
                p = (cx + radius * np.cos(th), y, cz + radius * np.sin(th))
                handles.append(sim.add_body(
                    BodyDescription.dynamic(p, box_id, 1.0, box, orientation=q)))
                col_of.append(c)
    return sim, config, handles, np.asarray(col_of)


def awake_fraction(sim) -> float:
    """The share of dynamic bodies awake (one read from the device)."""
    from ..bodies import KIND_DYNAMIC

    b = sim.state.bodies
    dyn = b.kind == KIND_DYNAMIC
    return float((b.awake & dyn).sum()) / max(1, int(dyn.sum()))


def _timed(sim, steps: int, dt: float) -> float:
    """``steps`` steps; steps per second on the host clock, the device drained."""
    sync = torch.cuda.synchronize if sim.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    sim.run(steps, dt)
    sync()
    return steps / (time.perf_counter() - t0)


def run_colosseum(sim, handles, col_of, dt: float = 1.0 / 60.0, window=_timed,
                  settle_runs: int = 20, timed: int = 32) -> dict:
    """``bench.py``'s colosseum sequence through the public API: 33 steps, ``autosize``
    (32 probe steps, headroom 2.0, pairs headroom 1.4), 33 steps; runs of 30 steps (at
    most ``settle_runs``) until under 5% of the dynamic bodies are awake; a timed
    settled window of ``timed`` steps; the topple (4 m/s added to the x velocity of every
    body of colosseum 0, through ``get_body`` and ``set_velocity``, before the clock
    starts: each call reads the host, and the edits reach the device before it too); a
    timed churn window of ``timed`` steps.
    ``window(sim, steps, dt)`` runs and times a window (steps/s). Returns the awake-fraction
    curve, the settled and post-topple fractions, the awake handles after the churn
    window, both steps/s, autosize's result, and the settled window's start and end
    positions and awake flags (device tensors)."""
    sim.run(33, dt)
    sized = sim.autosize(dt, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
    sim.run(33, dt)
    curve = []
    for _ in range(settle_runs):
        sim.run(30, dt)
        curve.append(awake_fraction(sim))
        if curve[-1] < 0.05:
            break
    b = sim.state.bodies
    before = (torch.stack(list(b.pos)).clone(), b.awake.clone())
    settled_sps = window(sim, timed, dt)
    b = sim.state.bodies
    after = (torch.stack(list(b.pos)).clone(), b.awake.clone())
    for h in np.asarray(handles)[col_of == 0]:
        v = sim.get_body(int(h))[2]
        sim.set_velocity(int(h), linear=(float(v[0]) + 4.0, float(v[1]), float(v[2])))
    sim.state  # the host's edits go to the device here, before the clock starts
    churn_sps = window(sim, timed, dt)
    awake = sim.state.bodies.awake.cpu().numpy()
    hs = np.asarray(handles)
    return dict(curve=curve, settled=curve[-1], post_topple=awake_fraction(sim),
                awake_handles=set(int(h) for h in hs[awake[hs]]), settled_sps=settled_sps,
                churn_sps=churn_sps, autosize=sized, settled_window=(before, after))
