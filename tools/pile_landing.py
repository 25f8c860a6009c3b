"""The ragdoll pile step by step through its landing, on one CUDA card (or the CPU at a
small size): after every step the lowest dynamic body (its y, slot and limb), how many
bodies are below y = -0.2, the step's ``overflow_src`` bits and its demand counters
(``simulation.StepDiagnostics.demand``). It runs bench.py's ragdoll sequence as
``chip_smoke.py`` phase 17 does (33 steps, ``--settle`` steps, autosize, 33, 32), and
prints every 16th step and every step with an overflow bit or a body below y = 0, then the
capacities after each stage.

``--set key=value`` overrides a field of the builder's config, to run the pile at other
capacities: at 8 pairs per body and the default grid caps (``--set max_pairs=81984 --set
wide_cap_rows=0 --set grid_cell_capacity=16 --set grid_pair_k=8``) the broad phase drops
pairs when the top layer lands and limbs fall through the ground.

    python3 tools/pile_landing.py [--ragdolls 1024] [--settle 95] [--device cuda]
        [--set key=value ...]

Imports nothing of JAX.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

LIMBS = ("torso", "head", "upper_arm_l", "upper_arm_r", "lower_arm_l", "lower_arm_r",
         "upper_leg_l", "upper_leg_r", "lower_leg_l", "lower_leg_r")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ragdolls", type=int, default=1024)
    ap.add_argument("--settle", type=int, default=95)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args()
    from bepuphysics2_tpu_torch import simulation as tsim
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
    from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim

    overrides = {k: int(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    sim, _ = build_ragdoll_pile_sim(args.ragdolls, device=args.device, **overrides)
    rows = []
    step = tsim.Simulation.timestep

    def recorded(self, dt=1.0 / 60.0):
        step(self, dt)
        b = self._state.bodies
        y = torch.where(b.kind == KIND_DYNAMIC, b.pos.y, float("inf"))
        d = self.last_diag
        rows.append(torch.cat([torch.stack([y.min(), y.argmin().float(),
                                            d.overflow_src.float(), (y < -0.2).sum().float()]),
                               d.demand.float()]))

    tsim.Simulation.timestep = recorded
    n = [0]

    def report(stage):
        for my, slot, src, below, *demand in (torch.stack(rows).cpu().tolist() if rows else []):
            n[0] += 1
            if n[0] % 16 == 0 or src or my < 0.0:
                print(f"{stage} step {n[0]}: min y {my:.3f} (slot {int(slot)}, "
                      f"{LIMBS[(int(slot) - 1) % 10]}), below -0.2: {int(below)}, overflow_src "
                      f"{int(src)}, demand {[int(x) for x in demand]}", flush=True)
        rows.clear()
        c = sim.config
        print(f"{stage} capacities: max_pairs {c.max_pairs}, store caps {c.store_caps()}, "
              f"wide_cap_rows {c.wide_cap_rows}, grid_cell_capacity {c.grid_cell_capacity}, "
              f"grid_pair_k {c.grid_pair_k}", flush=True)

    t0 = time.perf_counter()
    sim.run(33)
    report("warm")
    sim.run(args.settle)
    report("settle")
    sized = sim.autosize(1.0 / 60.0, probe_steps=32, headroom=2.0, pairs_headroom=1.4)
    report(f"autosize ({sized['rounds']} rounds)")
    sim.run(33)
    report("warm")
    sim.run(32)
    report("timed")
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
