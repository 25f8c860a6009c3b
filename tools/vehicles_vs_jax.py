"""One port step from each carried JAX state of a vehicle scene, against the JAX package's
next state, on the CPU: per frame the largest pose or velocity difference of each body
and of each joint type's impulses.

    JAX_PLATFORMS=cpu python tools/vehicles_vs_jax.py [--frames 3] [--colors 8] [--tank-only]
        [--ground -50] [--nudge]

The scene is ``tests/test_torch_vehicles.py``'s: the car at (-4, 0.8, 0) and the tank at
(4, 1.0, 0) (or the tank alone), 4 substeps, ``max_pairs`` 1,024, ``backend="pallas"``,
the ground's top at ``--ground`` + 0.5 (falling free by default). Imports both packages
(it is a reference tool, not part of the port); ~2 min on the CPU, most of it the JAX
compile. ``--nudge`` adds per frame the JAX package's own spread: the largest
difference of each body from its next state over 4 JAX steps from the same state with
every orientation (steps 1 and 3) or position (2 and 4) component scaled by 1 +- 1e-7.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def scene(mod, models, args):
    kw = dict(body_capacity=64, max_pairs=1024, substeps=4, num_colors=args.colors,
              joint_capacity=128, enable_sleep=False, solver_backend="pallas")
    sim = (mod.Simulation(mod.SimConfig(**kw)) if mod.__name__ == "bepuphysics2_tpu"
           else mod.Simulation(mod.SimConfig(**kw), device="cpu"))
    g = sim.add_shape(mod.Box(120.0, 0.5, 120.0))
    sim.add_static(mod.StaticDescription(position=(0, args.ground, 0), shape=g))
    if not args.tank_only:
        models.SimpleCar(sim, position=(-4.0, 0.8, 0.0))
    models.Tank(sim, position=(4.0, 1.0, 0.0), wheels_per_tread=3)
    return sim


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--colors", type=int, default=8)
    ap.add_argument("--tank-only", action="store_true")
    ap.add_argument("--ground", type=float, default=-50.0)
    ap.add_argument("--nudge", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    import bepuphysics2_tpu as jbp
    from bepuphysics2_tpu import models as jmodels

    import bepuphysics2_tpu_torch as tbp
    import bepuphysics2_tpu_torch.simulation as tsim
    from bepuphysics2_tpu_torch import models as tmodels
    from bepuphysics2_tpu_torch.interop import (
        joint_banks_from_numpy, shapes_from_numpy, state_from_numpy, state_to_numpy,
    )

    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    jsim, cfg = scene(jbp, jmodels, args), scene(tbp, tmodels, args).config
    states = [np_(jsim.state)]
    for _ in range(args.frames + 1):
        jsim.timestep(1 / 60)
        states.append(np_(jsim.state))
    banks = {n: {k: np.asarray(v) for k, v in st.device().items() if k != "impulse"}
             for n, st in jsim.joints.items() if st.count > 0}
    shapes = shapes_from_numpy(np_(jsim.shapes.device()), "cpu")
    present = tuple(sorted({int(t) for t in jsim.shapes.types if t >= 0}))
    rng = np.random.default_rng(0)

    def nudged(state, field):
        b = state.bodies
        part = type(getattr(b, field))(*[
            (np.asarray(c) * (1 + 1e-7 * rng.choice([-1.0, 1.0], size=np.shape(c))))
            .astype(np.float32) for c in getattr(b, field)])
        return jax.tree_util.tree_map(jax.numpy.asarray,
                                      state._replace(bodies=b._replace(**{field: part})))

    for frame in range(args.frames):
        before, want = states[frame], states[frame + 1]
        out, _ = tsim.step(state_from_numpy(before, "cpu"), shapes,
                           joint_banks_from_numpy(banks, "cpu"), 1 / 60, cfg, present)
        got = state_to_numpy(out)
        gap = np.max([np.abs(np.asarray(g) - np.asarray(w))
                      for f in ("pos", "orn", "vel", "omega")
                      for g, w in zip(getattr(got.bodies, f), getattr(want.bodies, f))], 0)
        kind = np.asarray(want.bodies.kind)
        print(f"frame {frame}: bodies {np.round(gap[kind == 1], 6).tolist()}")
        for n in sorted(want.joint_impulses):
            d = np.abs(np.asarray(got.joint_impulses[n]) - np.asarray(want.joint_impulses[n]))
            same = np.array_equal(got.joint_colors[n], want.joint_colors[n])
            print(f"  {n}: impulses {d.max():.2e}, colors equal {same}")
        if args.nudge:
            own = 0.0
            for field in ("orn", "pos", "orn", "pos"):
                jsim._state, jsim._dirty = nudged(before, field), False
                jsim.timestep(1 / 60)
                got_j = np_(jsim.state)
                own = np.maximum(own, np.max(
                    [np.abs(np.asarray(g) - np.asarray(w)) for f in ("pos", "orn", "vel", "omega")
                     for g, w in zip(getattr(got_j.bodies, f), getattr(want.bodies, f))], 0))
            print(f"  the JAX package's own spread under a 1e-7 nudge: "
                  f"{np.round(own[kind == 1], 6).tolist()}")


if __name__ == "__main__":
    main()
