"""The behaviour of the JAX package's ``tests/test_compound.py`` on the port's CPU, at
those tests' configurations and thresholds: two dumbbells stack (compound vs compound),
a ball rolls down a mesh ramp, mesh triangles are one-sided, and a ball rests on the far
corner of an 800-triangle floor without overflow. ``tests/test_torch_mesh.py`` holds the
functions to the JAX package's.
"""
import numpy as np
import pytest
import torch

import bepuphysics2_tpu_torch as tbp
from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim(**cfg):
    return tbp.Simulation(tbp.SimConfig(**cfg), device="cpu")


_CFG = dict(body_capacity=32, max_pairs=64, substeps=4, num_colors=4, max_compound_pairs=16,
            children_per_pair=8, child_window=16)


def test_compound_vs_compound_stacks():
    sim = _sim(**_CFG, max_cc_pairs=4, cc_children_per_side=4)
    g = sim.add_shape(tbp.Box(20.0, 0.5, 20.0))
    sim.add_static(tbp.StaticDescription(position=(0, -0.5, 0), shape=g))
    bs = sim.add_shape(tbp.Box(0.4, 0.4, 0.4))
    cs = sim.add_shape(tbp.Compound.build([(bs, (-0.5, 0, 0)), (bs, (0.5, 0, 0))]))
    ii = (1.0, 0.0, 1.0, 0.0, 0.0, 1.0)
    lo = sim.add_body(tbp.BodyDescription(position=(0, 0.5, 0), shape=cs, inv_mass=0.5,
                                          inv_inertia=ii, kind=KIND_DYNAMIC))
    hi = sim.add_body(tbp.BodyDescription(position=(0.05, 1.5, 0.0), shape=cs, inv_mass=0.5,
                                          inv_inertia=ii, kind=KIND_DYNAMIC))
    sim.run(240, 1 / 60.0)
    plo, phi, vhi = sim.get_body(lo)[0], sim.get_body(hi)[0], sim.get_body(hi)[2]
    assert not bool(sim.last_diag.overflow), "cc expansion overflowed"
    assert 0.3 < plo[1] < 0.5, f"bottom dumbbell rest height wrong: {plo}"
    assert 1.0 < phi[1] < 1.4, f"top dumbbell should rest on the bottom one: {phi}"
    assert np.linalg.norm(vhi) < 0.2, f"top dumbbell still moving: {vhi}"


def test_mesh_ramp_rolls_ball():
    sim = _sim(**_CFG)
    s = tbp.Sphere(0.4)
    ss = sim.add_shape(s)
    ramp = tbp.Mesh.build([((-3, 0, -3), (3, 1.0, 3), (3, 1.0, -3)),
                           ((-3, 0, -3), (-3, 0, 3), (3, 1.0, 3))])
    sim.add_static(tbp.StaticDescription(position=(0.0, 0.0, 0), shape=sim.add_shape(ramp)))
    ball = sim.add_body(tbp.BodyDescription.dynamic((2.0, 2.5, 0), ss, 1.0, s))
    sim.run(120, 1 / 60.0)
    pos = sim.get_body(ball)[0]
    assert pos[0] < 2.0, f"ball should roll down the ramp (-x): {pos}"
    assert pos[1] > 0.0, f"ball fell through the mesh: {pos}"


def test_mesh_one_sided():
    sim = _sim(**_CFG, enable_sleep=False)
    s = tbp.Sphere(0.3)
    ss = sim.add_shape(s)
    floor = tbp.Mesh.build([((-3, 2, -3), (3, 2, 3), (3, 2, -3)),
                            ((-3, 2, -3), (-3, 2, 3), (3, 2, 3))])
    sim.add_static(tbp.StaticDescription(position=(0, 0, 0), shape=sim.add_shape(floor)))
    above = sim.add_body(tbp.BodyDescription.dynamic((0.5, 4.0, 0.5), ss, 1.0, s))
    below = sim.add_body(tbp.BodyDescription.dynamic((-0.5, 0.0, -0.5), ss, 1.0, s,
                                                     velocity=(0, 9.0, 0)))
    sim.run(60, 1 / 60.0)
    pa, pb = sim.get_body(above)[0], sim.get_body(below)[0]
    assert pa[1] > 2.2, f"ball from above fell through the mesh: {pa}"
    assert pb[1] > 2.31 or pb[1] < 2.0, f"ball from below was stopped by a back face: {pb}"


def test_big_mesh_cluster_floor():
    tris = [t for x0 in range(-10, 10) for z0 in range(-10, 10)
            for t in (((x0, 0, z0), (x0, 0, z0 + 1), (x0 + 1, 0, z0)),
                      ((x0 + 1, 0, z0), (x0, 0, z0 + 1), (x0 + 1, 0, z0 + 1)))]
    sim = _sim(body_capacity=16, max_pairs=32, substeps=4, num_colors=4, max_compound_pairs=8,
               children_per_pair=16)
    mesh = sim.add_shape(tbp.Mesh.build(tris))
    s = tbp.Sphere(0.5)
    ss = sim.add_shape(s)
    sim.add_static(tbp.StaticDescription(position=(0, 0, 0), shape=mesh))
    b = sim.add_body(tbp.BodyDescription.dynamic((7.3, 2.0, -6.2), ss, 1.0, s))
    ovf = False
    for _ in range(120):
        sim.timestep(1 / 60.0)
        ovf = ovf or bool(sim.last_diag.overflow)
    pos = sim.get_body(b)[0]
    assert abs(pos[1] - 0.5) < 0.03, f"ball fell through the far corner: y={pos[1]}"
    assert not ovf
