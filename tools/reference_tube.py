"""The ragdoll tube on the CPU, through the JAX package (the reference) or the PyTorch port,
as ``bench.py`` builds it (``BENCH_SCENARIO=ragdoll_tube``): with ``--settings bench``,
bench.py's solver settings (color_cap_factor 1.0, jacobi_cap_factor 0.3, color_rounds 1);
with ``--settings default``, the packages' default ones (1.5, 0.3, 3). After the first step
and then every 32 steps it prints how many dynamic bodies are outside the tube (farther
than 5.0 from its axis, or below y = 0), which ragdolls they belong to, the largest
head-torso distance, the largest speed, and whether the last step overflowed (and where:
the ``overflow_src`` bits) with its Jacobi rows; both packages step frame by frame, so
those two report the last step alone. ``chip_smoke.py`` prints the same counts for the
port on the card.

    JAX_PLATFORMS=cpu python tools/reference_tube.py [--package jax|port]
        [--settings bench|default] [--ragdolls 32] [--steps 289]
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH = dict(color_cap_factor=1.0, jacobi_cap_factor=0.3, color_rounds=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--settings", choices=("bench", "default"), default="bench")
    ap.add_argument("--ragdolls", type=int, default=32)
    ap.add_argument("--steps", type=int, default=289)
    args = ap.parse_args()
    n = args.ragdolls
    if args.package == "jax":
        from __graft_entry__ import _build_ragdoll_tube_sim

        sim, _ = _build_ragdoll_tube_sim(n, substeps=4, num_colors=8)
        run = lambda k: sim.run(k, 1 / 60, chunk=0)
    else:
        from bepuphysics2_tpu_torch.models import build_ragdoll_tube_sim

        sim, _ = build_ragdoll_tube_sim(n, substeps=4, num_colors=8, device="cpu")
        run = lambda k: [sim.timestep(1 / 60) for _ in range(k)]
    if args.settings == "bench":
        sim.config = dataclasses.replace(sim.config, **BENCH)
        sim._dirty = True
    done = 0
    while done < args.steps:
        k = 1 if done == 0 else min(32, args.steps - done)
        run(k)
        done += k
        sim._sync_from_device()
        h = sim._host
        dyn = h.kind == 1
        p = np.stack([h.px, h.py, h.pz])
        out = dyn & ((np.hypot(p[0], p[1] - 6.0) >= 5.0) | (p[1] <= 0.0))
        apart = [np.linalg.norm(p[:, 2 + 10 * r] - p[:, 1 + 10 * r]) for r in range(n)]
        d = sim.last_diag
        print(f"step {done}: {int(out.sum())} of {int(dyn.sum())} dynamic bodies outside the "
              f"tube, ragdolls {sorted(set(((np.nonzero(out)[0] - 1) // 10).tolist()))}; "
              f"max head-torso {max(apart):.3f}; max |v| "
              f"{np.abs(np.stack([h.vx, h.vy, h.vz])).max():.4g}; overflow "
              f"{bool(d.overflow)} (src {int(d.overflow_src)}); Jacobi rows "
              f"{int(d.demand[5])}", flush=True)


if __name__ == "__main__":
    main()
