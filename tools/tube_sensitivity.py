"""How much one step of the 32-ragdoll tube amplifies a rounding-sized change of its state,
on the CPU through the PyTorch port: the tube at ``bench.py``'s solver settings is stepped
``--steps`` frames (its limbs are launched out of the tube by then, see
``tools/reference_tube.py``), then one step is taken from that state as it is and from
the same state with every velocity scaled by ``1 + eps * u`` (``u`` uniform in
[-0.5, 0.5], seed 0). Prints, per ``eps``, the largest |changed - unchanged| /
(1 + |unchanged|) of the bodies' position, orientation, velocity and angular velocity,
over every body and over the ragdolls that lie wholly inside the tube.

    python tools/tube_sensitivity.py [--steps 130]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke
    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.interop import state_from_numpy, state_to_numpy

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=130)
    args = ap.parse_args()
    n_rag = 32
    sim = chip_smoke.tube_sim(n_rag, "cpu")
    for _ in range(args.steps):
        sim.timestep(chip_smoke.DT)
    cfg, present = sim.config, sim._present_types()
    scene = (sim.shapes.device("cpu"), sim._joint_banks("cpu"))
    start = state_to_numpy(sim.state)

    def step(eps):
        st = state_from_numpy(start, "cpu")
        gen = torch.Generator().manual_seed(0)
        for t in st.bodies.vel:
            t.mul_(1 + eps * (torch.rand(t.shape, generator=gen) - 0.5))
        return tsim.step(st, *scene, chip_smoke.DT, cfg, present)[0].bodies

    inside = chip_smoke._ragdolls_inside(state_from_numpy(start, "cpu"), n_rag)
    base = step(0.0)
    print(f"after {args.steps} steps: {int(inside.sum()) // 10} of {n_rag} ragdolls inside "
          f"the tube; largest |position| {max(float(t.abs().max()) for t in base.pos):.4g}")
    for eps in (1e-7, 1e-6):
        got = step(eps)
        for f in ("pos", "orn", "vel", "omega"):
            rel = torch.stack([(g - w).abs() / (1 + w.abs())
                               for g, w in zip(getattr(got, f), getattr(base, f))]).amax(0)
            print(f"eps {eps:g} {f}: every body {float(rel.max()):.3e}, ragdolls inside "
                  f"{float(rel[inside].max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
