"""SKILL.md's first flow, the ball drop and rest, in the PyTorch port and the JAX package:
one sphere falls onto a static box and sleeps. It is a file of its own because the JAX
step compiles anew for its 8-substep configuration."""
import numpy as np

import bepuphysics2_tpu as jbp
import bepuphysics2_tpu_torch as tbp

DT = 1 / 60


def _ball_drop(mod):
    sim = mod.Simulation(mod.SimConfig(body_capacity=64, max_pairs=256, substeps=8))
    ground = sim.add_shape(mod.Box(50.0, 0.5, 50.0))
    s = mod.Sphere(0.5)
    ss = sim.add_shape(s)
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=ground))
    ball = sim.add_body(mod.BodyDescription.dynamic((0, 2.0, 0), ss, 1.0, s))
    sim.run(120, DT)
    pos, _, vel, _ = sim.get_body(ball)
    sim._sync_from_device()
    return pos, vel, sim._host.awake.copy()


def test_ball_drop_and_rest_matches_jax():
    jpos, _, jawake = _ball_drop(jbp)
    tpos, tvel, tawake = _ball_drop(tbp)
    assert abs(tpos[1] - jpos[1]) < 1e-3
    assert abs(tpos[1] - 0.5) < 5e-3 and np.abs(tvel).max() < 1e-3
    np.testing.assert_array_equal(tawake, jawake)
