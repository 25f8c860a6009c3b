"""Eight box-shaped convex hulls dropped on ``models.terrain_mesh(60)`` (hull vs mesh
triangle through the generic GJK/MPR manifold), in either package on the CPU: every 10th
step, each hull's centre height above the surface.

    JAX_PLATFORMS=cpu python tools/hulls_on_mesh.py --package jax|port
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from bepuphysics2_tpu_torch.models import terrain_height, terrain_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    if args.package == "jax":
        import bepuphysics2_tpu as mod
        kw = {}
    else:
        import bepuphysics2_tpu_torch as mod
        kw = dict(device="cpu")
    sim = mod.Simulation(mod.SimConfig(body_capacity=16, max_pairs=1024, substeps=4,
                                       num_colors=8, broadphase="brute", max_compound_pairs=64,
                                       children_per_pair=8, child_window=1024), **kw)
    sim.add_static(mod.StaticDescription(position=(0, 0, 0), shape=sim.add_shape(
        mod.Mesh.build(terrain_mesh(60).triangles))))
    corners = 0.3 * np.array([(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
                              for sz in (-1, 1)], np.float64)
    hull = mod.ConvexHull.from_points(corners)
    row = sim.add_shape(hull)
    rng = np.random.default_rng(1)
    spots = [(-3.41, 50.82)] + [tuple(rng.uniform(-54, 54, 2)) for _ in range(7)]
    for x, z in spots:
        q = rng.normal(size=4)
        sim.add_body(mod.BodyDescription.dynamic(
            (x, float(terrain_height(x, z)) + 1.6, z), row, 1.0, hull,
            orientation=tuple(q / np.linalg.norm(q))))
    for k in range(1, args.steps + 1):
        sim.timestep(1 / 60)
        if k % 10 == 0:
            sim._sync_from_device()
            h = sim._host
            dyn = h.kind == 1
            gap = h.py[dyn] - terrain_height(h.px[dyn], h.pz[dyn])
            print(f"{args.package} step {k}: heights above the surface "
                  f"{np.round(gap, 3).tolist()}", flush=True)


if __name__ == "__main__":
    main()
