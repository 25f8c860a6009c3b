"""The port's ray casts (``collision/raycast.py``) against the JAX package's, function
against function on the same numpy inputs (seed 0).

- The five analytic testers on 256 rays each, aimed at random points of the shape's
  bounding box from random origins: ``hit`` equal, and where it hit ``t`` and the normal
  within 1e-5. A ray whose JAX result jumps (the hit or the body flips, or t or the
  normal moves by over 1e-4) when its origin moves by 1e-6 or its direction scales by
  1 +- 1e-6 is within 1e-6 of grazing (or, for a box, of an edge, where the axis that
  sets the normal ties): it is reported, not held; at most one ray in sixteen may be.
- ``ray_cast_all`` on a 40-body scene of every shape, a compound and a mesh, built by the
  JAX package and carried into the port (``interop``): single rays (one with
  ``exclude``) and a batch of 64, at ``prune_k`` 0 and 8: ``hit``, ``body`` and
  ``saturated`` equal, ``t`` and the normal within 1e-5, under the same nudge rule. The
  JAX package tests each compound's children through a window as wide as the largest
  child count (``children_window``); the port through the host's flat list of child
  targets, and must pick the same body.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu.collision import raycast as jray
from bepuphysics2_tpu.shapes import registry as jreg
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

from bepuphysics2_tpu_torch.collision import raycast
from bepuphysics2_tpu_torch.interop import shapes_from_numpy, state_from_numpy
from bepuphysics2_tpu_torch.utils.vec import Vec3

TOL = 1e-5
NUDGE = 1e-6
JUMP = 1e-4  # a result that moves this much under a nudge of NUDGE jumped
_NUDGES = ((NUDGE, 1.0), (-NUDGE, 1.0), (0.0, 1 + NUDGE), (0.0, 1 - NUDGE))
N_RAYS = 256
MAX_T = 20.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one torch thread runs them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jv(a):
    return JVec3(*(jnp.asarray(a[..., i], jnp.float32) for i in range(3)))


def _tv(a):
    return Vec3(*(torch.as_tensor(np.array(a[..., i], np.float32)) for i in range(3)))


def _stack(v):
    return np.stack([np.asarray(c) for c in v], -1)


# --- the five testers -----------------------------------------------------------------

TESTERS = {  # name: (params, half extents of the box the rays aim into)
    "sphere": ((0.7,), (0.7, 0.7, 0.7)),
    "capsule": ((0.4, 0.6), (0.4, 1.0, 0.4)),
    "box": ((0.5, 0.3, 0.8), (0.5, 0.3, 0.8)),
    "cylinder": ((0.5, 0.7), (0.5, 0.7, 0.5)),
    "triangle": ((-0.8, -0.2, -0.5, 0.9, 0.1, -0.3, 0.1, 0.3, 0.9), (0.9, 0.3, 0.9)),
}


def _tester_call(mod, vec, name, params, o, d):
    p = [float(v) for v in params]
    fn = getattr(mod, f"_ray_{name}")
    if name in ("sphere",):
        return fn(vec(o), vec(d), p[0])
    if name in ("capsule", "cylinder"):
        return fn(vec(o), vec(d), p[0], p[1])
    if name == "box":
        return fn(vec(o), vec(d), vec(np.array(p, np.float32)))
    tri = np.array(p, np.float32).reshape(3, 3)
    return fn(vec(o), vec(d), vec(tri[0]), vec(tri[1]), vec(tri[2]))


def _rays(rng, n, half, spread=3.0):
    """Rays from random origins, aimed at random points of the box of half extents
    ``half`` and scaled in length, with some turned away."""
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-1.0, 1.0, (n, 3)) * np.asarray(half)
    d = (target - o) * rng.uniform(0.3, 2.0, (n, 1))
    d[: n // 8] *= -1.0  # away from the shape
    return o, d.astype(np.float32)


def _jax_tester(name, params, o, d):
    t, n, hit = _tester_call(jray, _jv, name, params, o, d)
    return np.asarray(hit), np.asarray(t), _stack(n)


def _unstable(name, params, o, d, base):
    """Rays whose JAX result moves under a relative nudge of the origin or direction."""
    hit0, t0, n0 = base
    bad = np.zeros(len(o), bool)
    for do, sd in _NUDGES:
        hit, t, n = _jax_tester(name, params, o + np.float32(do), d * np.float32(sd))
        bad |= hit != hit0
        bad |= hit0 & ((np.abs(t - t0) > JUMP) | (np.abs(n - n0).max(-1) > JUMP))
    return bad


@pytest.mark.parametrize("name", list(TESTERS))
def test_tester_matches_jax(name):
    params, half = TESTERS[name]
    rng = np.random.default_rng(0)
    o, d = _rays(rng, N_RAYS, half)
    want = _jax_tester(name, params, o, d)
    t, n, hit = _tester_call(raycast, _tv, name, params, o, d)
    got = hit.numpy(), t.numpy(), _stack(n)
    held = ~_unstable(name, params, o, d, want)
    print(f"{name}: {int(want[0].sum())} of {N_RAYS} rays hit; {int((~held).sum())} grazing "
          "rays reported, not held")
    assert held.mean() >= 15 / 16
    np.testing.assert_array_equal(got[0][held], want[0][held])
    h = held & want[0]
    np.testing.assert_allclose(got[1][h], want[1][h], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[2][h], want[2][h], rtol=TOL, atol=TOL)


# --- the scene --------------------------------------------------------------------------

def build_query_scene(seed=0):
    """A JAX Simulation of 40 bodies: a ground box, a 6 x 6 height-field mesh, a compound
    of a sphere, a box, a capsule and a cylinder, and dynamic spheres, capsules, boxes,
    cylinders, triangles and hulls at random poses with random velocities. Returns
    (sim, {name: (shape row, shape object)})."""
    rng = np.random.default_rng(seed)
    sim = jbp.Simulation(jbp.SimConfig(body_capacity=48, max_pairs=256, substeps=2,
                                       num_colors=4, max_cc_pairs=4))
    shapes = dict(
        sphere=jbp.Sphere(0.45), capsule=jbp.Capsule(0.3, 0.5), box=jbp.Box(0.5, 0.35, 0.4),
        cylinder=jbp.Cylinder(0.4, 0.45),
        triangle=jbp.Triangle((-0.6, 0, -0.4), (0.6, 0.1, -0.3), (0.0, -0.1, 0.7)),
        hull=jbp.ConvexHull.from_points(rng.normal(size=(24, 3)) * 0.5),
    )
    rows = {k: (sim.add_shape(v), v) for k, v in shapes.items()}
    ground = sim.add_shape(jbp.Box(20.0, 0.5, 20.0))
    sim.add_static(jbp.StaticDescription(position=(0, -0.5, 0), shape=ground))
    tris = []
    for i in range(6):
        for j in range(6):
            y = lambda a, b: 0.3 * np.sin(a) * np.cos(b)
            x0, z0 = float(i), float(j)
            v = [(x0, y(x0, z0), z0), (x0, y(x0, z0 + 1), z0 + 1), (x0 + 1, y(x0 + 1, z0), z0),
                 (x0 + 1, y(x0 + 1, z0 + 1), z0 + 1)]
            tris += [(v[0], v[1], v[2]), (v[2], v[1], v[3])]
    mesh = jbp.Mesh.build(tris)
    rows["mesh"] = (sim.add_shape(mesh), mesh)
    sim.add_static(jbp.StaticDescription(position=(6.0, 0.2, -3.0), shape=rows["mesh"][0]))
    comp = jreg.Compound.build([
        (rows["sphere"][0], (-1.0, 0.0, 0.0)), (rows["box"][0], (1.0, 0.0, 0.0)),
        (rows["capsule"][0], (0.0, 0.8, 0.0), (0.0, 0.0, 0.3826834, 0.9238795)),
        (rows["cylinder"][0], (0.0, -0.8, 0.0)),
    ])
    rows["compound"] = (sim.add_shape(comp), comp)
    sim.add_body(jbp.BodyDescription(position=(-4.0, 2.0, 3.0), shape=rows["compound"][0],
                                     orientation=(0.1, 0.2, 0.0, 0.9746794), inv_mass=0.5,
                                     inv_inertia=(1.0, 0.0, 1.0, 0.0, 0.0, 1.0),
                                     velocity=(0.3, -0.2, 0.1),
                                     angular_velocity=(0.2, 0.0, -0.3), kind=jbp.KIND_DYNAMIC))
    names = ["sphere", "capsule", "box", "cylinder", "triangle", "hull"]
    for i in range(37):
        name = names[i % len(names)]
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        row, obj = rows[name]
        sim.add_body(jbp.BodyDescription.dynamic(
            tuple(rng.uniform((-6, 0.5, -6), (6, 4.0, 6))), row, 1.0,
            obj if name != "triangle" else jbp.Sphere(0.5),
            orientation=tuple(q), velocity=tuple(rng.normal(size=3)),
            angular_velocity=tuple(rng.normal(size=3))))
    return sim, rows


def child_targets(state, shapes):
    """(owner, child row) of every child of every compound and mesh body in slot order,
    as ``Simulation._child_targets`` enumerates them."""
    shape = np.asarray(state.bodies.shape)
    kind = np.asarray(state.bodies.kind)
    types = np.asarray(shapes.type)
    owners, rows = [], []
    for b in range(len(shape)):
        s = int(shape[b])
        if s >= 0 and kind[b] != 0 and types[s] in (jreg.COMPOUND, jreg.BIG_COMPOUND,
                                                     jreg.MESH):
            start, count = int(shapes.child_start[s]), int(shapes.child_count[s])
            owners += [b] * count
            rows += list(range(start, start + count))
    return np.asarray(owners, np.int32), np.asarray(rows, np.int32)


@pytest.fixture(scope="module")
def scene():
    sim, rows = build_query_scene()
    state, shapes = _np(sim.state), _np(sim.shapes.device())
    owners, crow = child_targets(state, shapes)
    count = int(np.max(shapes.child_count))
    return dict(jstate=sim.state, jshapes=sim.shapes.device(), state=state,
                tstate=state_from_numpy(state, "cpu"), tshapes=shapes_from_numpy(shapes, "cpu"),
                owner=torch.from_numpy(owners), crow=torch.from_numpy(crow),
                window=1 << (count - 1).bit_length(), rows=rows)


def _scene_rays(scene, n):
    """Rays from above and from the sides toward random bodies, and some random ones."""
    rng = np.random.default_rng(1)
    pos = _stack(scene["state"].bodies.pos)[: 40]
    aim = pos[rng.integers(0, len(pos), n)] + rng.normal(scale=0.3, size=(n, 3))
    o = aim + rng.normal(size=(n, 3)) * np.array([3.0, 1.0, 3.0]) + np.array([0, 6.0, 0])
    o[: n // 4, 1] = rng.uniform(0.5, 2.5, n // 4)
    d = (aim - o) * rng.uniform(0.2, 1.5, (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _jax_cast(scene, o, d, prune_k=0, exclude=None):
    out = jray.ray_cast_all(scene["jstate"].bodies, scene["jshapes"], _jv(o), _jv(d),
                            jnp.float32(MAX_T),
                            exclude=None if exclude is None else jnp.int32(exclude),
                            children_window=scene["window"], prune_k=prune_k)
    return dict(hit=np.asarray(out.hit), t=np.asarray(out.t), body=np.asarray(out.body),
                normal=_stack(out.normal),
                saturated=None if out.saturated is None else np.asarray(out.saturated))


def _port_cast(scene, o, d, prune_k=0, exclude=None):
    out = raycast.ray_cast_all(scene["tstate"].bodies, scene["tshapes"], _tv(o), _tv(d),
                               MAX_T, exclude=exclude, child_owner=scene["owner"],
                               child_rows=scene["crow"], prune_k=prune_k)
    return dict(hit=out.hit.numpy(), t=out.t.numpy(), body=out.body.numpy(),
                normal=_stack(out.normal),
                saturated=None if out.saturated is None else out.saturated.numpy())


def _scene_unstable(scene, o, d, base, **kw):
    bad = np.zeros(np.shape(base["hit"]), bool)
    for do, sd in _NUDGES:
        got = _jax_cast(scene, o + np.float32(do), d * np.float32(sd), **kw)
        bad |= (got["body"] != base["body"]) | (np.abs(got["t"] - base["t"]) > JUMP) | (
            np.abs(got["normal"] - base["normal"]).max(-1) > JUMP)
    return bad


def _hold(got, want, held):
    for k in ("hit", "body"):
        np.testing.assert_array_equal(got[k][held], want[k][held], err_msg=k)
    if want["saturated"] is not None:
        np.testing.assert_array_equal(got["saturated"][held], want["saturated"][held])
    else:
        assert got["saturated"] is None
    np.testing.assert_allclose(got["t"][held], want["t"][held], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["normal"][held], want["normal"][held], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prune_k", [0, 8])
def test_batched_ray_cast_all_matches_jax(scene, prune_k):
    o, d = _scene_rays(scene, 64)
    want = _jax_cast(scene, o, d, prune_k)
    got = _port_cast(scene, o, d, prune_k)
    held = ~_scene_unstable(scene, o, d, want, prune_k=prune_k)
    comp_hits = np.isin(want["body"], [0, 1, 2]).sum()  # ground, mesh, compound
    print(f"prune_k {prune_k}: {int(want['hit'].sum())} of 64 rays hit, {comp_hits} on the "
          f"ground, the mesh or the compound; {int((~held).sum())} reported, not held")
    assert held.mean() >= 15 / 16 and want["hit"].sum() >= 32
    assert np.isin(want["body"], [1, 2]).sum() >= 2  # the children's pass decides some
    _hold(got, want, held)


@pytest.mark.parametrize("exclude", [None, 2])
def test_single_ray_cast_all_matches_jax(scene, exclude):
    o, d = _scene_rays(scene, 16)
    o[0] = (-4.0, 8.0, 3.0)  # straight down onto the compound
    d[0] = (0.0, -1.0, 0.0)
    for i in range(16):
        want = _jax_cast(scene, o[i], d[i], exclude=exclude)
        got = _port_cast(scene, o[i], d[i], exclude=exclude)
        if i == 0:
            assert int(want["body"]) == (0 if exclude == 2 else 2)
        _hold({k: np.asarray(v)[None] if v is not None else None for k, v in got.items()},
              {k: np.asarray(v)[None] if v is not None else None for k, v in want.items()},
              np.ones(1, bool))
