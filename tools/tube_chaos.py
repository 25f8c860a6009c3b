"""How fast trajectories of the 2-ragdoll tube (``tests/test_models.py``'s scene: 2
substeps, 4 colors) drift apart, on the CPU: the JAX package's default (XLA) path, its
Pallas path (kernels in interpret mode) and the port, ten frames each from the same
start. Prints per frame the largest position difference between each pair of
trajectories, and the difference between the JAX package's XLA and Pallas steps taken
from the same state (the per-step error without drift).

    JAX_PLATFORMS=cpu python tools/tube_chaos.py
"""
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 10
DT = 1 / 60


def _positions(sim):
    sim._sync_from_device()
    h = sim._host
    return np.stack([h.px, h.py, h.pz])


def main():
    import jax
    import jax.numpy as jnp

    import bepuphysics2_tpu.simulation as jsim
    from __graft_entry__ import _build_ragdoll_tube_sim
    from bepuphysics2_tpu_torch.models import build_ragdoll_tube_sim

    sims = {}
    for backend in ("auto", "pallas"):
        sim, _ = _build_ragdoll_tube_sim(2, substeps=2, num_colors=4)
        sim.config = dataclasses.replace(sim.config, solver_backend=backend)
        sim._dirty = True
        sims[backend] = sim
    sims["port"], _ = build_ragdoll_tube_sim(2, substeps=2, num_colors=4, device="cpu")
    xla = sims["auto"]
    present = tuple(sorted({int(t) for t in xla.shapes.types if t >= 0}))
    for frame in range(1, FRAMES + 1):
        before = jax.tree_util.tree_map(jnp.asarray, xla.state)
        banks = {n: {k: v for k, v in s.device().items() if k != "impulse"}
                 for n, s in xla.joints.items() if s.count > 0}
        pallas_step, _ = jsim.step(before, xla.shapes.device(), banks, jnp.float32(DT),
                                   sims["pallas"].config, present)
        for sim in sims.values():
            sim.timestep(DT)
        pos = {k: _positions(s) for k, s in sims.items()}
        one = np.abs(np.stack(jax.tree_util.tree_map(np.asarray, pallas_step.bodies.pos))
                     - pos["auto"]).max()
        print(f"frame {frame}: trajectories max |dpos| xla-pallas "
              f"{np.abs(pos['auto'] - pos['pallas']).max():.3e}, port-xla "
              f"{np.abs(pos['port'] - pos['auto']).max():.3e}, port-pallas "
              f"{np.abs(pos['port'] - pos['pallas']).max():.3e}; one step from the same "
              f"state xla-pallas {one:.3e}", flush=True)


if __name__ == "__main__":
    main()
