"""The ragdoll pile on the CPU, through the JAX package (the reference) or the PyTorch port,
at a Jacobi capacity of choice: ``n`` ragdolls standing in layers of 8 x 8 as
``bepuphysics2_tpu_torch.models.build_ragdoll_pile_sim`` places them (16 colors, 4
substeps, grid2), the JAX scene built from its public API. Each step it prints the
``overflow_src`` bits, the Jacobi rows the solver saw (``demand[5]``), the largest speed
and the largest head-torso distance.

At the packages' default ``jacobi_cap_factor`` 0.3 the first step sends 10 of each
ragdoll's 18 fresh joints to the joints' Jacobi bucket (the coloring's 3 rounds color
the rest), which holds 30% of them: the step spills (``overflow_src`` 2), the joints left
out are not solved, and over the next steps the limbs fly apart at ~2.4e4 m/s, in both
packages. At 0.6 nothing spills and every ragdoll stays whole.

    JAX_PLATFORMS=cpu python tools/reference_pile.py [--package jax|port]
        [--jacobi-cap-factor 0.3] [--ragdolls 128] [--steps 4]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--jacobi-cap-factor", type=float, default=0.3)
    ap.add_argument("--ragdolls", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    n = args.ragdolls
    from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim
    from bepuphysics2_tpu_torch.models.scenes import ragdoll_pile_config, ragdoll_pile_positions

    kw = dict(broadphase="grid2", jacobi_cap_factor=args.jacobi_cap_factor)
    if args.package == "jax":
        import bepuphysics2_tpu as jbp
        from bepuphysics2_tpu.models.ragdoll import add_ragdoll

        sim = jbp.Simulation(jbp.SimConfig(**{**ragdoll_pile_config(n), **kw}))
        ground = sim.add_shape(jbp.Box(100.0, 0.5, 100.0))
        sim.add_static(jbp.StaticDescription(position=(0.0, -0.5, 0.0), shape=ground))
        for p in ragdoll_pile_positions(n, (8, 8), 0):
            add_ragdoll(sim, position=tuple(float(c) for c in p))
    else:
        sim, _ = build_ragdoll_pile_sim(n, layer=(8, 8), device="cpu", **kw)
    for step in range(1, args.steps + 1):
        sim.timestep(1 / 60)
        sim._sync_from_device()
        h = sim._host
        p = np.stack([h.px, h.py, h.pz])
        speed = np.linalg.norm(np.stack([h.vx, h.vy, h.vz]), axis=0).max()
        apart = np.linalg.norm(p[:, 2 + 10 * np.arange(n)] - p[:, 1 + 10 * np.arange(n)], axis=0)
        d = sim.last_diag
        print(f"{args.package}, jacobi_cap_factor {args.jacobi_cap_factor}, step {step}: "
              f"overflow_src {int(d.overflow_src)}, Jacobi rows {int(np.asarray(d.demand)[5])}, "
              f"max speed {speed:.1f}, max head-torso {apart.max():.3f}", flush=True)


if __name__ == "__main__":
    main()
