"""The cloth over a sphere on the CPU, through the JAX package (the reference) or the
PyTorch port, at solver settings of choice: ``bepuphysics2_tpu_torch.models.build_cloth_sim``
's scene (a ``width`` x ``width`` lattice of ``center_distance`` links over a static sphere
on a static ground, its nodes in one collision group), the JAX scene built through its
public API and its own ``models.cloth.add_cloth``. Each step it prints the
``overflow_src`` bits, the Jacobi rows the solver saw (``demand[5]``) against the joints
(links), the lowest node and the largest speed.

The coloring is incremental: on the first step most fresh links have no color yet and go
to the Jacobi bucket (800 of a 16 x 16 lattice's 930), which holds ``jacobi_cap_factor``
of them. At bench.py's settings (color_cap_factor 1.0, jacobi_cap_factor 0.3, color_rounds
1) and at the package defaults (0.3, 3 rounds) the first steps spill (``overflow_src`` 2),
in both packages; at 1.0 nothing spills.

    JAX_PLATFORMS=cpu python tools/reference_cloth.py [--package jax|port] [--width 16]
        [--jacobi-cap-factor 0.3] [--bench] [--steps 4]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH = dict(color_cap_factor=1.0, jacobi_cap_factor=0.3, color_rounds=1)


def jax_cloth_sim(width: int, length: int, **overrides):
    """The JAX package's copy of ``build_cloth_sim``'s scene: the same config, statics and
    lattice (its ``add_cloth``, the nodes then made point masses and put in collision
    group 1). Returns (sim, config, grid)."""
    import bepuphysics2_tpu as jbp
    from bepuphysics2_tpu.models.cloth import add_cloth
    from bepuphysics2_tpu_torch.models.cloth import FREQUENCY, NODE_MASS, cloth_links

    spacing = 0.25
    n = width * length
    radius = 0.125 * width * spacing
    drop = overrides.pop("drop", 0.5)
    config = jbp.SimConfig(**{**dict(
        body_capacity=n + 8, max_pairs=max(4096, 4 * n), substeps=8, num_colors=16,
        jacobi_cap_factor=1.0, joint_capacity=max(256, cloth_links(width, length)),
        store_churn=max(256, n), broadphase="auto"), **overrides})
    sim = jbp.Simulation(config)
    half = 2 * max(width, length) * spacing
    sim.add_static(jbp.StaticDescription(position=(0.0, -0.5, 0.0),
                                         shape=sim.add_shape(jbp.Box(half, 0.5, half))))
    sim.add_static(jbp.StaticDescription(position=(0.0, radius, 0.0),
                                         shape=sim.add_shape(jbp.Sphere(radius))))
    origin = (-(width - 1) * spacing / 2, 2 * radius + drop, -(length - 1) * spacing / 2)
    grid = add_cloth(sim, origin=origin, width=width, length=length, spacing=spacing,
                     node_mass=NODE_MASS, frequency=FREQUENCY, pin_corners=False,
                     collidable=True)
    for h in grid.reshape(-1):
        sim.set_local_inertia(int(h), 1.0 / NODE_MASS, (0.0,) * 6)
    sim._sync_from_device()
    sim._host.collision_group[grid.reshape(-1)] = 1
    sim._dirty = True
    return sim, config, grid


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--jacobi-cap-factor", type=float, default=None)
    ap.add_argument("--bench", action="store_true", help="bench.py's solver settings")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    kw = dict(BENCH) if args.bench else {}
    if args.jacobi_cap_factor is not None:
        kw["jacobi_cap_factor"] = args.jacobi_cap_factor
    if args.package == "jax":
        sim, config, grid = jax_cloth_sim(args.width, args.width, **kw)
    else:
        from bepuphysics2_tpu_torch.models import build_cloth_sim

        sim, config, grid = build_cloth_sim(args.width, args.width, device="cpu", **kw)
    nodes = grid.reshape(-1)
    for step in range(1, args.steps + 1):
        sim.timestep(1 / 60)
        sim._sync_from_device()
        h = sim._host
        speed = np.linalg.norm(np.stack([h.vx, h.vy, h.vz]), axis=0)[nodes].max()
        d = sim.last_diag
        print(f"{args.package}, jacobi_cap_factor {config.jacobi_cap_factor}, color_rounds "
              f"{config.color_rounds}, step {step}: overflow_src {int(d.overflow_src)}, "
              f"Jacobi rows {int(np.asarray(d.demand)[5])} of {sim.constraint_count} links, "
              f"min node y {h.py[nodes].min():.3f}, max speed {speed:.2f}", flush=True)


if __name__ == "__main__":
    main()
