"""The port's scene queries through ``Simulation``, on the CPU: its own versions of the
JAX package's ``tests/test_queries.py`` (ray casts single, batched and pruned; the box
query and the coarse sweep; contact events; rays and sweeps against mesh triangles and
compound children; batched sweeps against single ones; pruned sweeps against full ones),
at the thresholds of those tests. ``tests/test_torch_raycast.py`` and
``tests/test_torch_sweeps.py`` hold the functions to the JAX package's; ``contacts`` and
``live_contact_pairs`` are held to the JAX package's in ``tests/test_torch_sim.py``.
"""
import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch import (
    BodyDescription, Box, Capsule, Compound, Cylinder, Mesh, SimConfig, Simulation, Sphere,
    StaticDescription,
)

DT = 1 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim(**cfg):
    return Simulation(SimConfig(**cfg), device="cpu")


def make_scene():
    sim = _sim(body_capacity=32, max_pairs=64, substeps=2, num_colors=2)
    shapes = {
        "sphere": Sphere(0.5), "box": Box(0.5, 0.5, 0.5), "capsule": Capsule(0.3, 0.5),
        "cylinder": Cylinder(0.4, 0.5),
    }
    handles = {}
    for x, (name, s) in zip((0.0, 3.0, 6.0, 9.0), shapes.items()):
        handles[name] = sim.add_body(BodyDescription.dynamic((x, 1, 0), sim.add_shape(s), 1.0, s))
    return sim, handles


def _grid_mesh(n, lo):
    tris = []
    for i in range(n):
        for j in range(n):
            x0, z0 = i + lo, j + lo
            tris.append(((x0, 0, z0), (x0, 0, z0 + 1), (x0 + 1, 0, z0)))
            tris.append(((x0 + 1, 0, z0), (x0, 0, z0 + 1), (x0 + 1, 0, z0 + 1)))
    return Mesh.build(tris)


def test_ray_hits_each_shape():
    sim, handles = make_scene()
    for name, x in [("sphere", 0.0), ("box", 3.0), ("capsule", 6.0), ("cylinder", 9.0)]:
        hit = sim.ray_cast((x, 5.0, 0.0), (0.0, -1.0, 0.0), 10.0)
        assert hit.t.device.type == "cpu" and hit.t.dim() == 0
        assert bool(hit.hit), f"ray missed {name}"
        assert int(hit.body) == handles[name], f"ray hit wrong body for {name}"
        assert float(hit.normal.y) > 0.7, f"bad normal for {name}: {hit.normal}"
    assert not bool(sim.ray_cast((50.0, 5.0, 0.0), (0.0, -1.0, 0.0), 10.0).hit)


def test_batched_and_pruned_rays():
    sim, handles = make_scene()
    origins = np.array([[0, 5, 0], [3, 5, 0], [6, 5, 0], [9, 5, 0], [50, 5, 0]], np.float32)
    dirs = np.tile(np.array([[0, -1, 0]], np.float32), (5, 1))
    full = sim.ray_cast(origins, dirs, 10.0)
    assert full.hit.tolist() == [True, True, True, True, False]
    assert full.body.tolist()[:2] == [handles["sphere"], handles["box"]]
    assert full.saturated is None
    pruned = sim.ray_cast(origins, dirs, 10.0, prune_k=3)
    assert full.hit.tolist() == pruned.hit.tolist()
    assert full.body.tolist() == pruned.body.tolist()
    np.testing.assert_allclose(pruned.t.numpy(), full.t.numpy(), rtol=1e-6)
    np.testing.assert_allclose(pruned.normal.y.numpy(), full.normal.y.numpy(), rtol=1e-5)
    assert not pruned.saturated.any()


def test_box_query_and_sweep():
    sim, handles = make_scene()
    found = sim.box_query((-1, 0, -1), (4, 2, 1))
    assert handles["sphere"] in found and handles["box"] in found
    assert handles["cylinder"] not in found
    hit, t, body = sim.sweep(Sphere(0.2), (0, 1, -5), (0, 0, 1), 20.0)
    assert hit and body == handles["sphere"]
    assert 3.0 < t < 5.0


def test_contact_events():
    """began / persisted / ended pair tracking; a sleeping pair persists."""
    sim = _sim(body_capacity=32, max_pairs=64, substeps=2, num_colors=2)
    ground = sim.add_shape(Box(30.0, 0.5, 30.0))
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    ball = sim.add_body(BodyDescription.dynamic((8.0, 1.8, 0.0), sim.add_shape(Sphere(0.4)),
                                                1.0, Sphere(0.4)))
    sim.contact_events()
    sim.run(60, DT)
    ev = sim.contact_events()
    assert any(ball in p for p in ev["began"]), f"no began event for the landing: {ev}"
    sim.run(90, DT)
    ev = sim.contact_events()
    assert any(ball in p for p in ev["persisted"]), f"the contact should persist: {ev}"
    sim.set_velocity(ball, linear=(0, 20.0, 0))
    sim.run(30, DT)
    ev = sim.contact_events()
    assert any(ball in p for p in ev["ended"]), f"the contact should end: {ev}"


def test_ray_hits_mesh_and_compound():
    sim = _sim(body_capacity=16, max_pairs=32, substeps=2, num_colors=2)
    ss = sim.add_shape(Sphere(0.5))
    cs = sim.add_shape(Compound.build([(ss, (0, 0, -2)), (ss, (0, 0, 2))]))
    sim.add_body(BodyDescription.kinematic((0, 0, 0), shape=cs))
    floor = Mesh.build([((-3, 0, -3), (3, 0, 3), (3, 0, -3)), ((-3, 0, -3), (-3, 0, 3), (3, 0, 3))])
    sim.add_static(StaticDescription(position=(10, 0, 0), shape=sim.add_shape(floor)))
    hit = sim.ray_cast((0, 5, 2), (0, -1, 0), 10.0)
    assert bool(hit.hit) and abs(float(hit.t) - 4.5) < 1e-2
    hit = sim.ray_cast((10, 5, 0), (0, -1, 0), 10.0)
    assert bool(hit.hit) and abs(float(hit.t) - 5.0) < 1e-2
    assert not bool(sim.ray_cast((0, 5, 0), (0, -1, 0), 10.0).hit)


def test_raycast_big_mesh_far_triangle():
    """The far corner of an 800-triangle mesh lies deep in the child pool."""
    sim = _sim(body_capacity=8, max_pairs=8, substeps=2, num_colors=2)
    sim.add_static(StaticDescription(position=(0, 0, 0),
                                     shape=sim.add_shape(_grid_mesh(20, -10.0))))
    hit = sim.ray_cast(origin=(9.5, 5.0, 9.5), direction=(0.0, -1.0, 0.0))
    assert bool(hit.hit) and abs(float(hit.t) - 5.0) < 1e-3


def test_sweep_against_mesh_and_compound_children():
    sim = _sim(body_capacity=8, max_pairs=8, substeps=2, num_colors=2)
    sim.add_static(StaticDescription(position=(0, 0, 0),
                                     shape=sim.add_shape(_grid_mesh(4, -2.0))))
    bid = sim.add_shape(Box(0.5, 0.5, 0.5))
    comp = sim.add_shape(Compound.build([(bid, (3.0, 1.0, 0.0)), (bid, (3.0, 2.5, 0.0))]))
    sim.add_body(BodyDescription.kinematic((0.0, 0.0, 0.0), comp))
    hit = sim.sweep_shape(Sphere(0.5), (0.5, 5.0, 0.5), (0, -1, 0), max_t=10.0)
    assert bool(hit.hit) and abs(float(hit.t) - 4.5) < 0.02, float(hit.t)
    hit2 = sim.sweep_shape(Sphere(0.5), (3.0, 6.0, 0.0), (0, -1, 0), max_t=10.0)
    assert bool(hit2.hit) and abs(float(hit2.t) - 2.5) < 0.02, float(hit2.t)
    assert int(hit2.body) == 1


def test_sweep_shape_batch_matches_single():
    sim = _sim(body_capacity=16, max_pairs=32, substeps=2, num_colors=2)
    g = sim.add_shape(Box(20.0, 0.5, 20.0))
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=g))
    sim.add_body(BodyDescription.dynamic((0, 3.0, 0), sim.add_shape(Sphere(0.5)), 1.0,
                                         Sphere(0.5)))
    sim.timestep(DT)
    probe = Sphere(0.2)
    positions = np.array([[0, 8.0, 0], [5.0, 8.0, 0], [0, 8.0, 5.0]], np.float32)
    velocities = np.tile(np.array([0, -10.0, 0], np.float32), (3, 1))
    batch = sim.sweep_shape_batch(probe, positions, velocities, max_t=3.0)
    for i in range(3):
        single = sim.sweep_shape(probe, tuple(positions[i]), tuple(velocities[i]), max_t=3.0)
        assert bool(batch.hit[i]) == bool(single.hit)
        if bool(single.hit):
            assert abs(float(batch.t[i]) - float(single.t)) < 1e-5
            assert int(batch.body[i]) == int(single.body)
    assert bool(batch.hit[0]) and int(batch.body[0]) == 1
    assert bool(batch.hit[1]) and int(batch.body[1]) == 0


def test_pruned_sweep_matches_full():
    sim, _ = make_scene()
    s = Sphere(0.3)
    sim.add_shape(s)
    rng = np.random.default_rng(4)
    P = np.stack([rng.uniform(-4, 4, 8), np.full(8, 6.0), rng.uniform(-4, 4, 8)], -1)
    V = np.tile(np.array([0.0, -6.0, 0.0]), (8, 1))
    full = sim.sweep_shape_batch(s, P, V, max_t=3.0)
    pruned = sim.sweep_shape_batch(s, P, V, max_t=3.0, prune_k=8)
    assert full.hit.tolist() == pruned.hit.tolist()
    assert full.body.tolist() == pruned.body.tolist()
    np.testing.assert_allclose(full.t.numpy(), pruned.t.numpy(), atol=1e-5)
    assert pruned.saturated is not None
