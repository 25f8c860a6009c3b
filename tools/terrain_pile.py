"""Track ``models.build_terrain_pile_sim``'s pile step by step: the lowest body's centre
above the terrain (and which body, of which kind), ``overflow_src`` and the demand
counters, and the first step where a body's centre is below the surface.

    python3 tools/terrain_pile.py [--bodies 4096] [--cells 60] [--steps 60] [--device cpu]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from bepuphysics2_tpu_torch.models import build_terrain_pile_sim, terrain_height

    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=4096)
    ap.add_argument("--cells", type=int, default=60)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], help="config key=value")
    args = ap.parse_args()
    over = {k: type(getattr(__import__("bepuphysics2_tpu_torch").SimConfig(), k))(v)
            for k, v in (s.split("=") for s in args.set)}
    sim, _ = build_terrain_pile_sim(args.bodies, args.cells, device=args.device, **over)
    kinds = ["sphere", "box"]
    for step in range(1, args.steps + 1):
        sim.timestep(1 / 60)
        b = sim.state.bodies
        dyn = (b.kind == 1).cpu().numpy()
        p = np.stack([c.cpu().numpy() for c in b.pos])
        gap = np.where(dyn, p[1] - terrain_height(p[0], p[2]), np.inf)
        i = int(np.argmin(gap))
        kind = "dumbbell" if (i - 1) % 8 == 7 else kinds[(i - 1) % 2]
        d = sim.last_diag
        print(f"step {step}: lowest body {i} ({kind}) at ({p[0, i]:.2f}, {p[2, i]:.2f}) "
              f"{gap[i]:.3f} above the surface; overflow_src {int(d.overflow_src)}; demand "
              f"{d.demand.tolist()}", flush=True)


if __name__ == "__main__":
    main()
