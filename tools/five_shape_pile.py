"""Track the five-shape pile (``chip_smoke.five_shapes`` on ``chip_smoke.build_pile``'s
layout and settings) step by step and report where a body first sinks.

    python3 tools/five_shape_pile.py [--bodies 4096] [--steps 129] [--device cuda]
        [--ground 100]

Each step it records the lowest dynamic body (its height, shape type and handle); at the
first step that leaves a dynamic body's centre below ``--floor`` (0.1 m above the ground's
top by default: no shape of the mix rests that low) it prints that body's pose and
velocity before and after the step and every live store record that names it (the other
body, its type, the contact normals and depths), then stops. ``--ground`` sets the ground
box's half extent (100 as ``bench.py``; 20 for the CPU tests' pile), ``--max-pairs`` the
pair capacity (``bench.py``'s 8 per body by default). Prints one JSON line at the end: the
lowest bodies of the last steps, the first overflow (step, ``overflow_src`` bits, the
demand vector) and the peak demand.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TYPES = {0: "sphere", 1: "capsule", 2: "box", 3: "triangle", 4: "cylinder", 5: "hull"}


def _body(st, i):
    b = st.bodies
    return dict(pos=[round(float(c[i]), 5) for c in b.pos],
                vel=[round(float(c[i]), 5) for c in b.vel],
                omega=[round(float(c[i]), 5) for c in b.omega])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bodies", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=129)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ground", type=float, default=100.0)
    ap.add_argument("--floor", type=float, default=0.1)
    ap.add_argument("--max-pairs", type=int, default=None)
    args = ap.parse_args()
    from bepuphysics2_tpu_torch import Box
    from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC

    extra = {} if args.max_pairs is None else dict(max_pairs=args.max_pairs)
    sim = cs.build_pile(args.bodies, args.device, shapes=cs.five_shapes(), **extra)
    if args.ground != 100.0:
        ground = Box(args.ground, 0.5, args.ground)
        sim.shapes.params[0, :3] = (args.ground, 0.5, args.ground)
        sim.shapes.max_radius[0] = ground.maximum_radius()
        sim.shapes.shapes[0] = ground
        sim.shapes._device = {}
    types = sim.shapes.types
    low, first_overflow, peak = [], None, None
    for step in range(args.steps):
        before = sim.state
        sim.timestep(cs.DT)
        st = sim.state
        d = sim.last_diag
        peak = d.demand.clone() if peak is None else torch.maximum(peak, d.demand)
        if first_overflow is None and bool(d.overflow):
            first_overflow = dict(step=step + 1, src=int(d.overflow_src),
                                  demand=d.demand.tolist())
        dyn = st.bodies.kind == KIND_DYNAMIC
        y = torch.where(dyn, st.bodies.pos.y, torch.full_like(st.bodies.pos.y, 1e9))
        i = int(torch.argmin(y))
        kind = TYPES.get(int(types[int(st.bodies.shape[i])]))
        low.append((step + 1, round(float(y[i]), 4), kind))
        if float(y[i]) < args.floor:
            s = st.store
            rows = torch.nonzero((s.live > 0) & ((s.body_a == i) | (s.body_b == i))).flatten()
            print(f"step {step + 1}: body {i} ({low[-1][2]}) at y {float(y[i]):.4f}; before "
                  f"{_body(before, i)}; after {_body(st, i)}", flush=True)
            for r in rows.tolist():
                other = int(s.body_b[r]) if int(s.body_a[r]) == i else int(s.body_a[r])
                print(f"  record {r}: with body {other} "
                      f"({TYPES.get(int(types[int(st.bodies.shape[other])]))}), "
                      f"y {float(st.bodies.pos.y[other]):.4f}", flush=True)
            break
    print(json.dumps(dict(bodies=args.bodies, ground=args.ground, steps=len(low),
                          max_pairs=sim.config.max_pairs, lowest=low[-8:],
                          sank=low[-1][1] < args.floor, first_overflow=first_overflow,
                          peak_demand=peak.tolist())))


if __name__ == "__main__":
    main()
