"""Queue 1 item 19, continuous collision detection, through the port against the JAX
package on the CPU, on one scene built by the JAX package and carried into the port: a
thin static wall, a static compound of two thin panels, a static 6 x 6-cell mesh, and
spheres, boxes and capsules, half of them continuous and fast.

- ``sweeps.pair_toi``: the analytic two-sphere case of ``tests/test_ccd.py`` (gap 3.8
  closing at 10 m/s: t = 0.38, 32 iterations) and 64 pairs at its 12 iterations, body
  against body and against the children of the compound and of the mesh, within 1e-4.
- ``narrowphase.ccd_eval_times`` on every pair of close bounds, with room for every risk
  pair, and ``convex_pair_records(max_ccd > 0)`` with fewer slots than risk pairs (the
  cap keeps the first in pair order): the evaluation times within 1e-4 and the contact
  records (normal, depth, offsets within 1e-4; masks equal).
- ``narrow_phase_compound`` with those times as ``pair_t``: the compound's and the mesh's
  children at the advanced poses, their depths warped back to t = 0, as the JAX
  package's records.
- ``tests/test_ccd.py``'s behaviours on the port: the 120 m/s bullet stopped by the thin
  wall, and the 130 m/s one by the first panel of the compound.
- The bullet scene stepped by the port 3 times, each from the JAX package's state, within
  1e-4 of the JAX step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu.collision import narrowphase as jnarrow
from bepuphysics2_tpu.collision import sweeps as jsweeps

import bepuphysics2_tpu_torch as tbp
from bepuphysics2_tpu_torch.collision import narrowphase, sweeps
from bepuphysics2_tpu_torch.interop import shapes_from_numpy, state_from_numpy

DT = np.float32(1 / 60.0)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def scene():
    """The JAX scene, its state and shapes in both packages, its present types."""
    sim = jbp.Simulation(jbp.SimConfig(body_capacity=48, max_pairs=256, substeps=4,
                                       num_colors=4, max_ccd_pairs=8, enable_sleep=False,
                                       max_compound_pairs=16, children_per_pair=8))
    wall = sim.add_shape(jbp.Box(0.2, 3.0, 3.0))
    sim.add_static(jbp.StaticDescription(position=(5.0, 2.0, 0.0), shape=wall))
    panel = sim.add_shape(jbp.Box(0.25, 2.0, 2.0))
    comp = sim.add_shape(jbp.Compound([(panel, (0.0, 0.0, 0.0), (0, 0, 0, 1)),
                                       (panel, (3.0, 0.0, 0.0), (0, 0, 0, 1))]))
    sim.add_static(jbp.StaticDescription(position=(5.0, 2.0, 8.0), shape=comp))
    tris = []
    for i in range(6):
        for j in range(6):
            y = lambda a, b: 0.3 * np.sin(a) * np.cos(b)
            v = [(i, y(i, j), j), (i, y(i, j + 1), j + 1), (i + 1, y(i + 1, j), j),
                 (i + 1, y(i + 1, j + 1), j + 1)]
            tris += [(v[0], v[1], v[2]), (v[2], v[1], v[3])]
    mesh = sim.add_shape(jbp.Mesh.build([[tuple(float(c) for c in p) for p in t]
                                         for t in tris]))
    sim.add_static(jbp.StaticDescription(position=(-4.0, -1.0, -8.0), shape=mesh))
    rng = np.random.default_rng(0)
    objs = [jbp.Sphere(0.1), jbp.Sphere(0.3), jbp.Box(0.2, 0.3, 0.25), jbp.Capsule(0.15, 0.3)]
    ids = [sim.add_shape(o) for o in objs]
    targets = np.array([[5.0, 2.0, 0.0], [5.0, 2.0, 8.0], [-1.0, -0.8, -5.0]])
    for k in range(36):
        aim = targets[k % 3] + rng.normal(scale=(0.3, 1.0, 1.0))
        start = aim - np.array([rng.uniform(0.5, 4.0), rng.uniform(-1, 1), rng.uniform(-1, 1)])
        if k % 3 == 2:
            start = aim + np.array([rng.uniform(-1, 1), rng.uniform(0.5, 3.0), rng.uniform(-1, 1)])
        speed = rng.uniform(20.0, 150.0) if k % 2 == 0 else rng.uniform(0.5, 5.0)
        vel = (aim - start) / np.linalg.norm(aim - start) * speed
        q = rng.normal(size=4)
        o = k % len(objs)
        sim.add_body(jbp.BodyDescription.dynamic(
            tuple(start), ids[o], 0.1 if o == 0 else 1.0, objs[o],
            orientation=tuple(q / np.linalg.norm(q)), velocity=tuple(vel),
            angular_velocity=tuple(rng.normal(size=3)), continuity=int(k % 2 == 0)))
    state = sim.state
    shapes = sim.shapes.device()
    present = tuple(sorted({int(t) for t in sim.shapes.types if t >= 0}))
    return dict(jstate=state.bodies, jshapes=shapes, present=present, config=sim.config,
                tstate=state_from_numpy(_np(state), "cpu").bodies,
                tshapes=shapes_from_numpy(_np(shapes), "cpu"), n=sim.body_count)


def _pairs(scene):
    """Every pair of bodies whose predicted bounds (grown by their motion this step)
    overlap, as the broad phase would list them, lower slot first."""
    b = scene["jstate"]
    pos = np.stack([np.asarray(c) for c in b.pos], -1)
    vel = np.stack([np.asarray(c) for c in b.vel], -1)
    r = np.asarray(scene["jshapes"].max_radius)[np.maximum(np.asarray(b.shape), 0)]
    reach = r + np.linalg.norm(vel, axis=1) * float(DT) + 0.1
    kind = np.asarray(b.kind)
    a_, b_ = [], []
    for i in range(scene["n"]):
        for j in range(i + 1, scene["n"]):
            d = np.linalg.norm(pos[i] - pos[j])
            if d < reach[i] + reach[j] + 4.0 and (kind[i] == 1 or kind[j] == 1):
                a_.append(i)
                b_.append(j)
    return np.asarray(a_, np.int32), np.asarray(b_, np.int32)


def test_pair_toi_two_spheres_analytic(scene):
    """``tests/test_ccd.py``'s analytic case in both packages: two spheres of radius 0.1
    with centres 4 apart closing at 10 m/s touch at t = 0.38."""
    results = []
    for pkg in ("jax", "port"):
        sim = (jbp.Simulation(jbp.SimConfig(body_capacity=8, max_pairs=16)) if pkg == "jax"
               else tbp.Simulation(tbp.SimConfig(body_capacity=8, max_pairs=16), device="cpu"))
        mod = jbp if pkg == "jax" else tbp
        s = mod.Sphere(0.1)
        ss = sim.add_shape(s)
        a = sim.add_body(mod.BodyDescription.dynamic((0, 5, 0), ss, 1.0, s, velocity=(10, 0, 0)))
        b = sim.add_body(mod.BodyDescription.dynamic((4, 5, 0), ss, 1.0, s))
        if pkg == "jax":
            t = jsweeps.pair_toi(sim.state.bodies, sim.shapes.device(), jnp.array([a]),
                                 jnp.array([b]), jnp.array([True]), jnp.float32(1.0), iters=32)
        else:
            t = sweeps.pair_toi(sim.state.bodies, sim.shapes.device("cpu"), torch.tensor([a]),
                                torch.tensor([b]), torch.tensor([True]), 1.0, iters=32)
        results.append(float(np.asarray(t)[0]))
    assert abs(results[1] - 0.38) < 0.02, results
    assert abs(results[1] - results[0]) <= TOL, results


def test_pair_toi_matches_jax(scene):
    """64 of the scene's close pairs: every pair with a static side (the wall, the
    compound, the mesh), then others drawn from a seed; a quarter not live. t within
    1e-4."""
    a, b = _pairs(scene)
    rng = np.random.default_rng(1)
    static = np.nonzero(a < 3)[0]
    rest = rng.permutation(np.nonzero(a >= 3)[0])
    pick = np.r_[static, rest][:64]
    a, b = a[pick], b[pick]
    live = rng.random(64) < 0.75
    want = np.asarray(jax.jit(lambda s, sh, a, b, l: jsweeps.pair_toi(s, sh, a, b, l, DT))(
        scene["jstate"], scene["jshapes"], a, b, live))
    got = sweeps.pair_toi(scene["tstate"], scene["tshapes"], torch.from_numpy(a),
                          torch.from_numpy(b), torch.from_numpy(live), float(DT)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    types = np.asarray(scene["jshapes"].type)[np.asarray(scene["jstate"].shape)[np.r_[a, b]]]
    assert {jbp.shapes.registry.COMPOUND, jbp.shapes.registry.MESH} <= set(types.tolist())
    assert ((want < DT) & live).sum() >= 4  # pairs that impact within the step


def _records_close(got, want):
    mask = np.asarray(want.contact_mask)
    np.testing.assert_array_equal(got.contact_mask.numpy(), mask)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for f in ("normal", "offset_a", "offset_b"):
        for g, w in zip(getattr(got, f), getattr(want, f)):
            w = np.asarray(w)
            g = g.numpy()
            if w.ndim == 2:
                g, w = np.where(mask, g, 0.0), np.where(mask, w, 0.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=f)
    np.testing.assert_allclose(np.where(mask, got.depth.numpy(), 0.0),
                               np.where(mask, np.asarray(want.depth), 0.0), rtol=0, atol=TOL)


def _args(scene):
    a, b = _pairs(scene)
    valid = np.ones(a.size, bool)
    port = (scene["tstate"], scene["tshapes"], torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(valid), float(DT))
    return (scene["jstate"], scene["jshapes"], a, b, valid), port


def test_ccd_eval_times_match_jax(scene):
    """The candidate pass with room for every risk pair (512 slots): the evaluation times
    within 1e-4."""
    jargs, targs = _args(scene)
    want = np.asarray(jax.jit(lambda s, sh, a, b, v: jnarrow.ccd_eval_times(
        s, sh, a, b, v, DT, 512))(*jargs))
    got = narrowphase.ccd_eval_times(*targs, 512, scene["present"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 4 < (want > 0).sum() < 512


def test_convex_records_with_ccd_match_jax(scene):
    """The convex records with 4 CCD slots for more risk pairs (the first 4 in pair order
    are swept): the evaluation times within 1e-4 and the records as the JAX package's
    (pairs with a compound or a mesh side take the compound path: both mask them out)."""
    jargs, targs = _args(scene)
    want_ps, want_te = jax.jit(lambda s, sh, a, b, v: jnarrow.convex_pair_records(
        s, sh, a, b, v, DT, present_types=scene["present"], max_ccd=4))(*jargs)
    got_ps, got_te = narrowphase.convex_pair_records(*targs, present_types=scene["present"],
                                                     max_ccd=4)
    want_te = np.asarray(want_te)
    np.testing.assert_allclose(got_te.numpy(), want_te, rtol=0, atol=TOL)
    assert (want_te > 0).sum() == 4
    _records_close(got_ps, want_ps)


def test_compound_records_at_the_toi_match_jax(scene):
    """The compound path (``narrow_phase_compound``) over every close pair, with the
    candidate pass's evaluation times as ``pair_t`` in both packages: the children of the
    compound and the mesh evaluated at the advanced poses and their depths warped back to
    t = 0 (JAX ``narrowphase.py:546``, ``:625-626``), as the JAX package's records."""
    from bepuphysics2_tpu.collision.broadphase import PairList as JPairList
    from bepuphysics2_tpu_torch.collision.broadphase import PairList

    jargs, targs = _args(scene)
    t = narrowphase.ccd_eval_times(*targs, 512, scene["present"])
    cfg = scene["config"]
    cap = cfg.max_compound_pairs * cfg.children_per_pair
    caps = (cfg.max_compound_pairs, cfg.children_per_pair, cfg.child_window)
    a, b, valid = jargs[2:]
    want = jax.jit(lambda s, sh, a, b, v, t: jnarrow.narrow_phase_compound(
        s, sh, JPairList(a, b, v, jnp.bool_(False)), jnarrow.PairCache.empty(cap), DT, *caps,
        present_types=scene["present"], pair_t=t))(*jargs, t.numpy())
    got = narrowphase.narrow_phase_compound(
        targs[0], targs[1], PairList(*targs[2:5], torch.tensor(False)),
        narrowphase.PairCache.empty(cap), float(DT), *caps, present_types=scene["present"],
        pair_t=t, meshes_meet=False)
    _records_close(got[0], want[0])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert bool(got[4]) == bool(want[4])
    swept = np.asarray(want[0].valid) & (np.asarray(want[0].depth).max(-1) < 0)
    assert (t > 0).any() and swept.any()


def bullet_sim(mod, ccd_pairs=8, compound=False):
    """``tests/test_ccd.py``'s bullet scenes: a 0.1 m sphere at 120 m/s at a wall 0.4 m
    thick, or at 130 m/s at the first of a compound's two panels 0.5 m thick."""
    cfg = dict(body_capacity=16, max_pairs=32, substeps=4, num_colors=2,
               max_ccd_pairs=ccd_pairs, enable_sleep=False)
    if compound:
        cfg.update(max_compound_pairs=16, children_per_pair=8)
    sim = (mod.Simulation(mod.SimConfig(**cfg), device="cpu") if mod is tbp
           else mod.Simulation(mod.SimConfig(**cfg)))
    if compound:
        panel = sim.add_shape(mod.Box(0.25, 4.0, 4.0))
        shape = sim.add_shape(mod.Compound([(panel, (0.0, 0.0, 0.0), (0, 0, 0, 1)),
                                            (panel, (3.0, 0.0, 0.0), (0, 0, 0, 1))]))
    else:
        shape = sim.add_shape(mod.Box(0.2, 10.0, 10.0))
    sim.add_static(mod.StaticDescription(position=(5.0, 0.0, 0.0), shape=shape))
    s = mod.Sphere(0.1)
    bullet = sim.add_body(mod.BodyDescription.dynamic(
        (0.0, 0.0, 0.0), sim.add_shape(s), 0.1, s,
        velocity=(130.0 if compound else 120.0, 0, 0), continuity=1))
    return sim, bullet


@pytest.mark.parametrize("compound", [False, True], ids=["wall", "compound_panel"])
def test_bullet_is_stopped(compound):
    sim, bullet = bullet_sim(tbp, compound=compound)
    for _ in range(30):
        sim.timestep(float(DT))
    pos = sim.get_body(bullet)[0]
    assert pos[0] < 5.0, f"the bullet tunnelled: {pos}"


def test_bullet_steps_match_jax():
    """Three port steps, each from the JAX package's state, within 1e-4 of the JAX step
    (the bullet meets the wall in the third)."""
    from bepuphysics2_tpu_torch.interop import state_to_numpy

    jsim, _ = bullet_sim(jbp)
    tsim, _ = bullet_sim(tbp)
    jsim.run(1, float(DT))  # 2 m a step: the first step only moves the bullet
    for frame in range(3):
        tsim._state = state_from_numpy(_np(jsim.state), "cpu")
        tsim._dirty = False
        jsim.timestep(float(DT))
        tsim.timestep(float(DT))
        want, got = _np(jsim.state).bodies, state_to_numpy(tsim.state).bodies
        for f in ("pos", "vel", "orn", "omega"):
            for g, w in zip(getattr(got, f), getattr(want, f)):
                np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=f"{f} {frame}")
    assert float(np.asarray(jsim.state.bodies.pos.x)[1]) < 5.0
