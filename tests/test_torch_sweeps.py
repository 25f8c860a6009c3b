"""The port's shape sweeps (``collision/sweeps.py`` ``sweep_shape_all``) against the JAX
package's, on the 40-body scene of ``tests/test_torch_raycast.py`` (every shape, a
compound and a mesh, built by the JAX package and carried into the port), with the
compound's and the mesh's children as targets.

A batch of 8 sweeps of each of a sphere, a box, a capsule and a hull, at ``prune_k`` 0
and 8: the JAX package maps ``sweep_shape_all`` over the batch (``vmap``), the port takes
it in one call. ``hit``, ``body`` and ``saturated`` equal and ``t`` within 1e-4, on every
sweep whose JAX result is stable: the sweeps run 32 GJK calls of up to 24 iterations
each, and GJK is ill-conditioned in both packages (ROADMAP queue 3: one ulp can stop it an
iteration early), so a sweep whose JAX result moves by more than 1e-5 when every body's
position scales by 1 + 1e-7 is reported, not held; at least three quarters must be held.

The sweeps leave the 40 m ground box out (its slot emptied in the state both packages
take). Compiled, the JAX package's GJK stops at that box's edge for a sphere above it: a
distance of 10.048 where the same function run op by op, and the port, find the face
below at 4.587, so the JAX sweep misses the ground that the sphere reaches at t = 1.5935
(the first sweep of this draw; ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu.collision import sweeps as jsweeps
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Vec3 as JVec3

from bepuphysics2_tpu_torch.collision import sweeps
from bepuphysics2_tpu_torch.interop import state_from_numpy
from bepuphysics2_tpu_torch.utils.vec import Quat, Vec3

from test_torch_raycast import _np, scene  # noqa: F401  (the module's fixture)

TOL = 1e-4
STABLE = 1e-5
N_SWEEPS = 8
MAX_T = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one torch thread runs them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _casts(scene, n):
    """Sweeps from above and from the side toward random bodies, spinning."""
    rng = np.random.default_rng(2)
    pos = np.stack([np.asarray(c) for c in scene["state"].bodies.pos], -1)[:40]
    aim = pos[rng.integers(0, 40, n)] + rng.normal(scale=0.3, size=(n, 3))
    start = aim + rng.normal(size=(n, 3)) * np.array([1.5, 0.5, 1.5]) + np.array([0, 3.0, 0])
    vel = (aim - start) * rng.uniform(0.5, 1.5, (n, 1))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.normal(scale=0.5, size=(n, 3))
    return [a.astype(np.float32) for a in (start, q, vel, w)]


def _jax_sweeper(jshapes, shape_obj, row, owner, crow, prune_k):
    """The JAX package's batch of sweeps of ``shape_obj``, compiled once: f(bodies, casts)."""
    type_id, packed = shape_obj.pack()
    params = np.zeros(12, np.float32)
    params[: len(packed)] = packed
    v3 = lambda a: JVec3(*(a[:, i] for i in range(3)))

    @jax.jit
    def run(bodies, p, q, v, w):
        def one(p, q, v, w):
            return jsweeps.sweep_shape_all(
                bodies, jshapes, type_id, jnp.asarray(params), jnp.int32(row), p, q, v, w,
                jnp.float32(shape_obj.maximum_radius()), jnp.float32(MAX_T),
                child_owner=jnp.asarray(owner), child_rows=jnp.asarray(crow),
                prune_k=prune_k)

        return jax.vmap(one)(v3(p), JQuat(*(q[:, i] for i in range(4))), v3(v), v3(w))

    def call(bodies, casts):
        out = run(jax.tree_util.tree_map(jnp.asarray, bodies), *map(jnp.asarray, casts))
        return dict(hit=np.asarray(out.hit), t=np.asarray(out.t), body=np.asarray(out.body),
                    saturated=None if out.saturated is None else np.asarray(out.saturated))

    return call


def _without_ground(bodies):
    """The bodies with slot 0 (the ground box) emptied."""
    kind = np.asarray(bodies.kind).copy()
    kind[0] = 0
    return bodies._replace(kind=kind)


def _nudged(bodies, scale):
    return bodies._replace(pos=type(bodies.pos)(*(np.asarray(c) * np.float32(scale)
                                                  for c in bodies.pos)))


@pytest.mark.parametrize("prune_k", [0, 8])
@pytest.mark.parametrize("name", ["sphere", "box", "capsule", "hull"])
def test_sweep_shape_all_matches_jax(scene, name, prune_k):
    row, obj = scene["rows"][name]
    casts = _casts(scene, N_SWEEPS)
    bodies = _without_ground(scene["state"].bodies)
    sweep = _jax_sweeper(scene["jshapes"], obj, row, scene["owner"].numpy(),
                         scene["crow"].numpy(), prune_k)
    want = sweep(bodies, casts)
    held = np.ones(N_SWEEPS, bool)
    for scale in (1 + 1e-7,):
        moved = sweep(_nudged(bodies, scale), casts)
        held &= (moved["body"] == want["body"]) & (np.abs(moved["t"] - want["t"]) <= STABLE)

    type_id, packed = obj.pack()
    params = np.zeros(12, np.float32)
    params[: len(packed)] = packed
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    p, q, v, w = casts
    out = sweeps.sweep_shape_all(
        state_from_numpy(scene["state"]._replace(bodies=bodies), "cpu").bodies,
        scene["tshapes"], type_id, t(params), row,
        Vec3(*(t(p[:, i]) for i in range(3))), Quat(*(t(q[:, i]) for i in range(4))),
        Vec3(*(t(v[:, i]) for i in range(3))), Vec3(*(t(w[:, i]) for i in range(3))),
        float(np.float32(obj.maximum_radius())), MAX_T, child_owner=scene["owner"],
        child_rows=scene["crow"], prune_k=prune_k)
    got = dict(hit=out.hit.numpy(), t=out.t.numpy(), body=out.body.numpy(),
               saturated=None if out.saturated is None else out.saturated.numpy())
    print(f"{name}, prune_k {prune_k}: {int(want['hit'].sum())} of {N_SWEEPS} sweeps hit, "
          f"bodies {sorted(set(want['body'].tolist()))}; {int((~held).sum())} reported, "
          "not held")
    assert held.mean() >= 0.75 and want["hit"].sum() >= N_SWEEPS // 3
    for k in ("hit", "body"):
        np.testing.assert_array_equal(got[k][held], want[k][held], err_msg=k)
    if prune_k:
        np.testing.assert_array_equal(got["saturated"][held], want["saturated"][held])
    else:
        assert got["saturated"] is None and want["saturated"] is None
    np.testing.assert_allclose(got["t"][held], want["t"][held], rtol=TOL, atol=TOL)
