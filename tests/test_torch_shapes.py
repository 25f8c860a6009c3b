"""The shapes the port gains in slice 11 against the JAX package's, on the same inputs:
``Cylinder``, ``Triangle``, ``ConvexHull`` and ``CustomShape`` (``pack``,
``compute_inertia``, ``maximum_radius`` within 1e-5), the port's own native quickhull
against the JAX package's ``ConvexHull.from_points`` (the same vertices, centroid and
inertia within 1e-6 relative, a hull above 64 vertices included), the world bounds of
every type within 1e-5, and the hull pool and custom ids carried by ``interop``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu.shapes import custom as jcustom
from bepuphysics2_tpu.shapes import registry as jreg

from bepuphysics2_tpu_torch.interop import shapes_from_numpy, state_to_numpy
from bepuphysics2_tpu_torch.shapes import custom as tcustom
from bepuphysics2_tpu_torch.shapes import registry as treg

from test_torch_convex import (  # noqa: F401  (the fixtures ellipsoid and scene)
    TIGHT, _q, _quats, _sphere_points, _torch_ellipsoid, _v, _vclose, ellipsoid, scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one torch thread runs them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_new_shapes_pack_and_inertia_match_jax(scene):
    rng = np.random.default_rng(0)
    pts = _sphere_points(rng, 200, 0.7) * np.array([1.0, 0.6, 0.8])
    for jshape, tshape in (
            (jreg.Cylinder(0.5, 0.4), treg.Cylinder(0.5, 0.4)),
            (jreg.Triangle((0, 0, 0), (1, 0.2, 0), (0.1, 0, 1.3)),
             treg.Triangle((0, 0, 0), (1, 0.2, 0), (0.1, 0, 1.3))),
            (jreg.ConvexHull.from_points(pts), treg.ConvexHull.from_points(pts)),
            (jcustom.CustomShape(scene["ellipsoid"], (0.6, 0.3, 0.4), 0.6, (0.05, 0.1, 0.09)),
             tcustom.CustomShape(scene["ellipsoid"], (0.6, 0.3, 0.4), 0.6, (0.05, 0.1, 0.09)))):
        assert jshape.pack() == tshape.pack()
        np.testing.assert_allclose(tshape.maximum_radius(), jshape.maximum_radius(),
                                   rtol=0, atol=TIGHT)
        for got, want in zip(tshape.compute_inertia(2.5), jshape.compute_inertia(2.5)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TIGHT)


@pytest.mark.parametrize("n_points", [24, 200])
def test_quickhull_matches_jax(n_points):
    """The port's native quickhull against the JAX package's ``ConvexHull.from_points``:
    the same vertex set, centroid and inertia within 1e-6 relative (200 points on an
    ellipsoid give a hull of more than 64 vertices)."""
    from bepuphysics2_tpu_torch import native

    assert native.load() is not None  # the native path, not scipy's
    rng = np.random.default_rng(n_points)
    pts = _sphere_points(rng, n_points, 0.5) * np.array([1.0, 0.7, 0.9])
    jh, th = jreg.ConvexHull.from_points(pts), treg.ConvexHull.from_points(pts)
    assert sorted(th.points) == sorted(jh.points)
    assert (n_points < 64) or len(th.points) > 64
    np.testing.assert_allclose(th.center_offset, jh.center_offset, rtol=1e-6, atol=1e-12)
    _, _, tinv = th.compute_inertia(3.0)
    _, _, jinv = jh.compute_inertia(3.0)
    np.testing.assert_allclose(tinv, jinv, rtol=1e-6, atol=1e-12)


def test_bounds_of_the_new_types_match_jax(scene):
    from bepuphysics2_tpu.shapes import bounds as jbounds
    from bepuphysics2_tpu_torch.shapes import bounds as tbounds

    rng = np.random.default_rng(0)
    rows = np.array(list(scene["rows"].values()) * 8, np.int32)
    n = rows.shape[0]
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    orn = _quats(rng, n)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    omega = rng.normal(size=(n, 3)).astype(np.float32) * 3
    spec = rng.uniform(0.0, 0.2, n).astype(np.float32)
    want = jbounds.compute_body_bounds(_v("jax", pos), _q("jax", orn), _v("jax", vel),
                                       _v("jax", omega), jnp.asarray(rows), scene["jshapes"],
                                       np.float32(1 / 60), spec_min=jnp.asarray(spec))
    got = tbounds.compute_body_bounds(_v("t", pos), _q("t", orn), _v("t", vel),
                                      _v("t", omega), torch.from_numpy(rows), scene["tshapes"],
                                      float(np.float32(1 / 60)), spec_min=torch.from_numpy(spec))
    for g, w, what in zip(got, want, ("min", "max")):
        _vclose(g, w, TIGHT, what)


def test_interop_carries_the_hull_pool_and_custom_ids(scene):
    """A JAX ``ShapeData`` with two hulls (24 and more than 64 vertices) and a custom
    shape into the port and back: every field the port keeps equal, each hull's table of
    pool rows its run of the pool; an unregistered custom id is refused."""
    jshapes = jax.tree_util.tree_map(np.asarray, scene["jshapes"])
    tshapes = shapes_from_numpy(jshapes, "cpu")
    back = state_to_numpy(tshapes)
    for f in back._fields:
        if f != "hull_rows":
            np.testing.assert_array_equal(getattr(back, f), getattr(jshapes, f), err_msg=f)
    hulls = np.nonzero(jshapes.type == jreg.CONVEX_HULL)[0]
    assert len(hulls) == 2 and max(jshapes.hull_count[hulls]) > 64
    for row in hulls:
        start, count = jshapes.hull_start[row], jshapes.hull_count[row]
        rows = back.hull_rows[row]
        np.testing.assert_array_equal(rows[:count], np.arange(start, start + count))
        assert (rows[count:] == -1).all()
    assert scene["ellipsoid"] in set(back.type.tolist())
    tcustom.CUSTOM_SUPPORTS.pop(scene["ellipsoid"])
    try:
        with pytest.raises(ValueError, match="not registered"):
            shapes_from_numpy(jshapes, "cpu")
    finally:
        tcustom.register_custom_shape(_torch_ellipsoid, type_id=scene["ellipsoid"])


def test_custom_ids_are_the_registrys():
    """``register_custom_shape`` hands out ids from 16 up, takes a given free one, and
    refuses a built-in or a taken one; the registry refuses an unregistered custom type."""
    fn = lambda params, d: (d, params[..., 0])
    tid = tcustom.register_custom_shape(fn, name="probe")
    try:
        assert tid >= 16 and tcustom.is_custom(tid) and tcustom.CUSTOM_NAMES[tid] == "probe"
        for bad in (5, tid):
            with pytest.raises(ValueError):
                tcustom.register_custom_shape(fn, type_id=bad)
        with pytest.raises(ValueError, match="not registered"):
            treg.ShapeRegistry(4).add(tcustom.CustomShape(tid + 1000))
    finally:
        tcustom.CUSTOM_SUPPORTS.pop(tid)
