"""The 64 x 64 cloth of ``models.build_cloth_sim`` under variants of its settings, on the
card: per variant, every 25 steps up to 200, the largest link extension and compression
(length / rest - 1), the nodes' mean speed and the overflow bits. Shows why the builder
takes point-mass nodes and 60 Hz links: with ``add_cloth``'s spinning nodes the drape
rolls on and stretches past 10%, and at its 25 Hz the links stretch by 13%.

    python3 tools/cloth_variants.py        # ~6 min on an H100
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bepuphysics2_tpu_torch.models import build_cloth_sim  # noqa: E402
from bepuphysics2_tpu_torch.models.cloth import NODE_MASS  # noqa: E402

# (name, build_cloth_sim overrides, link frequency, spinning nodes)
VARIANTS = [("60 Hz, spinning nodes", {}, 60.0, True),
            ("60 Hz, point masses (the builder's)", {}, 60.0, False),
            ("60 Hz, point masses, dropped 0.1 m", dict(drop=0.1), 60.0, False),
            ("25 Hz, point masses", {}, 25.0, False),
            ("60 Hz, point masses, 2 iterations", dict(velocity_iterations=2), 60.0, False)]


def main():
    import chip_smoke

    print(chip_smoke._nvidia_smi(), flush=True)
    for name, kw, freq, spin in VARIANTS:
        sim, _, grid = build_cloth_sim(64, 64, device="cuda", **kw)
        bank = sim.joints["center_distance"]
        if freq != 60.0:  # the builder's links at another frequency
            bank.prestep[:, 1] = freq * 2.0 * 3.141592653589793
            bank._device = {}
        nodes = [int(h) for h in grid.reshape(-1)]
        if spin:  # add_cloth's own sphere inertia
            from bepuphysics2_tpu_torch.shapes import Sphere

            inv_mass, diag = Sphere(0.25 * 0.3).compute_inertia(NODE_MASS)
            for h in nodes:
                sim.set_local_inertia(h, inv_mass, (diag[0], 0.0, diag[1], 0.0, 0.0, diag[2]))
        dev = bank.device("cuda")
        a, b, rest = dev["bodies"][:, 0].long(), dev["bodies"][:, 1].long(), dev["prestep"][:, 0]
        idx = torch.as_tensor(nodes, device="cuda")
        t0, out = time.perf_counter(), []
        for k in range(8):
            sim.run(25, 1 / 60)
            st = sim.state.bodies
            pos = torch.stack(list(st.pos), -1)
            strain = (pos[a] - pos[b]).norm(dim=-1) / rest - 1
            speed = torch.stack(list(st.vel), -1)[idx].norm(dim=-1).mean()
            out.append(f"{(k + 1) * 25}: +{float(strain.max()):.3f}/{float(strain.min()):.3f} "
                       f"v{float(speed):.3f} o{int(sim.last_diag.overflow_src)}")
        torch.cuda.synchronize()
        print(f"{name} ({time.perf_counter() - t0:.1f} s): " + " ".join(out), flush=True)


if __name__ == "__main__":
    main()
