"""Steps per second of scenes on the card with the joint sweep and the generic narrow phase
replayed as CUDA graphs (``utils/replay.py``) and run eagerly, in turns, in one process.

    python3 tools/replay_speed.py [--steps 20] [--scenes rigs,car,tank,five_shape]

Scenes (``chip_smoke.py``'s builders): the 30-rig battery (every joint type, K3), the car
and the tank of ``tests/test_models.py`` (``vehicle_world``: joints beside cylinder
wheels on the generic narrow phase, K3), and the 4,096-body five-shape pile (the generic
narrow phase beside K1). Each scene is built once per mode, warmed up 4 steps (the
replayed mode captures its graphs there), then timed over ``--steps`` steps, eager,
replayed, eager, replayed; the state hashes of the two modes must agree. Prints one line
per scene and one JSON line. Needs one card.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bepuphysics2_tpu_torch.utils import replay  # noqa: E402


def build(name, dev):
    if name == "rigs":
        from bepuphysics2_tpu_torch.models.joint_rigs import build_joint_rigs
        return build_joint_rigs(dev, steps=0).sim
    if name in ("car", "tank"):
        return cs.vehicle_world(name, dev)[0]
    return cs.build_pile(4096, dev, shapes=cs.five_shapes(), **cs.FIVE_SHAPE_CAPS)


def timed(name, dev, replayed, steps):
    replay.clear()
    replay.enabled = replayed
    try:
        sim = build(name, dev)
        sim.run(4, cs.DT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(steps, cs.DT)
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0), sim.state_hash()
    finally:
        replay.enabled = True


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scenes", default="rigs,car,tank,five_shape")
    args = ap.parse_args()
    dev = torch.device("cuda")
    name, smi = cs.phase_device()
    cs.phase_build()
    out = {}
    for scene in args.scenes.split(","):
        runs = [timed(scene, dev, r, args.steps) for r in (False, True, False, True)]
        eager, graphed = [runs[0][0], runs[2][0]], [runs[1][0], runs[3][0]]
        same = len({h for _, h in runs}) == 1
        out[scene] = dict(eager_steps_per_s=eager, replayed_steps_per_s=graphed,
                          same_hash=same)
        print(f"[replay] {scene}: {args.steps} steps after 4 on {name} ({smi}): eager "
              f"{eager[0]:.3f} / {eager[1]:.3f} steps/s, replayed {graphed[0]:.3f} / "
              f"{graphed[1]:.3f}; state hashes equal {same}", flush=True)
    print(json.dumps(out))
    return 0 if all(v["same_hash"] for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
