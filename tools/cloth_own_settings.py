"""The cloth with ``add_cloth``'s own settings, step by step, in either package on the CPU:
``build_cloth_sim``'s scene and config with links of 25 Hz, spinning nodes (the spheres
``add_cloth`` makes, not point masses) and the default ``store_churn`` (an eighth of the
pair store). Prints each step's ``overflow_src`` and store admissions (``demand[3]``),
and the first step that sets bit 4 (the pair store).

    JAX_PLATFORMS=cpu python tools/cloth_own_settings.py --package jax|port --width 24
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OWN = dict(store_churn=0)  # the default: max(128, capacity // 8)
FREQUENCY = 25.0  # add_cloth's default


def own_cloth_sim(package: str, width: int, drop: float = 0.5, **overrides):
    """``build_cloth_sim``'s scene in ``package`` ("jax" or "port", on the CPU), with
    ``add_cloth``'s own link frequency, node inertia and store churn. Returns (sim, grid)."""
    from bepuphysics2_tpu_torch.models.cloth import NODE_MASS, cloth_links

    if package == "jax":
        import bepuphysics2_tpu as mod
        from bepuphysics2_tpu.models.cloth import add_cloth
        kw = {}
    else:
        import bepuphysics2_tpu_torch as mod
        from bepuphysics2_tpu_torch.models.cloth import add_cloth
        kw = dict(device="cpu")
    spacing, n = 0.25, width * width
    radius = 0.125 * width * spacing
    config = mod.SimConfig(**{**dict(
        body_capacity=n + 8, max_pairs=max(4096, 4 * n), substeps=8, num_colors=16,
        jacobi_cap_factor=1.0, joint_capacity=max(256, cloth_links(width, width)),
        broadphase="auto"), **OWN, **overrides})
    sim = mod.Simulation(config, **kw)
    half = 2 * width * spacing
    sim.add_static(mod.StaticDescription(position=(0.0, -0.5, 0.0),
                                         shape=sim.add_shape(mod.Box(half, 0.5, half))))
    sim.add_static(mod.StaticDescription(position=(0.0, radius, 0.0),
                                         shape=sim.add_shape(mod.Sphere(radius))))
    origin = (-(width - 1) * spacing / 2, 2 * radius + drop, -(width - 1) * spacing / 2)
    grid = add_cloth(sim, origin=origin, width=width, length=width, spacing=spacing,
                     node_mass=NODE_MASS, frequency=FREQUENCY, pin_corners=False,
                     collidable=True)
    sim._sync_from_device()
    sim._host.collision_group[grid.reshape(-1)] = 1
    sim._dirty = True
    return sim, grid


def step_bits(sim, steps: int):
    """Per step: (overflow_src, store admissions demand[3], store live rows demand[4])."""
    out = []
    for _ in range(steps):
        sim.timestep(1 / 60)
        d = sim.last_diag
        out.append((int(d.overflow_src), int(np.asarray(d.demand)[3]),
                    int(np.asarray(d.demand)[4])))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--width", type=int, default=24)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if args.package == "port":
        import torch
        torch.set_num_threads(4)
    sim, _ = own_cloth_sim(args.package, args.width)
    churn = sim.config.store_caps()[0]
    first = None
    for k, (src, admit, live) in enumerate(step_bits(sim, args.steps)):
        print(f"step {k + 1}: overflow_src {src}, admissions {admit} (churn cap {churn}), "
              f"live rows {live}", flush=True)
        if src & 4 and first is None:
            first = k + 1
    print(f"{args.package}, {args.width} x {args.width}: first step with bit 4: {first}")


if __name__ == "__main__":
    main()
