"""The port's math modules (utils/vec, utils/spring, utils/packing, integrator) and its
host-side body buffer against the JAX package's, on the same seeded numpy inputs.

Tolerance 1e-6 relative (with a 1e-6 absolute floor for values near zero): both sides run
the same float32 operations in the same order; only the transcendental functions (sin,
cos, sqrt, log2) come from different libraries."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu.bodies as jbodies
import bepuphysics2_tpu.integrator as jintegrator
import bepuphysics2_tpu.shapes as jshapes
import bepuphysics2_tpu.utils.packing as jpacking
import bepuphysics2_tpu.utils.spring as jspring
import bepuphysics2_tpu.utils.vec as jvec

import bepuphysics2_tpu_torch.bodies as tbodies
import bepuphysics2_tpu_torch.integrator as tintegrator
import bepuphysics2_tpu_torch.shapes as tshapes
import bepuphysics2_tpu_torch.utils.packing as tpacking
import bepuphysics2_tpu_torch.utils.spring as tspring
import bepuphysics2_tpu_torch.utils.vec as tvec
from bepuphysics2_tpu_torch.interop import _to_torch

N = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ns(vec, spring, packing, integrator, bodies, shapes, arr):
    return SimpleNamespace(
        Vec3=vec.Vec3, Vec2=vec.Vec2, Quat=vec.Quat, Mat3=vec.Mat3, Sym3=vec.Sym3,
        Sym2=vec.Sym2, integrate_orientation=vec.integrate_orientation,
        build_orthonormal_basis=vec.build_orthonormal_basis,
        SpringSettings=spring.SpringSettings, compute_springiness=spring.compute_springiness,
        compact_true=packing.compact_true, gather_rows=packing.gather_rows,
        integrator=integrator, bodies=bodies, shapes=shapes, arr=arr,
    )


JAX = _ns(jvec, jspring, jpacking, jintegrator, jbodies, jshapes, jnp.asarray)
TORCH = _ns(tvec, tspring, tpacking, tintegrator, tbodies, tshapes, torch.from_numpy)


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _unit_quat(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _v3(m, a):
    return m.Vec3(*(m.arr(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _q(m, a):
    return m.Quat(*(m.arr(np.ascontiguousarray(a[:, i])) for i in range(4)))


def _spd(rng, n):
    """Well-conditioned symmetric positive definite 3x3s, lower-triangle order."""
    s = np.zeros((n, 6), np.float32)
    s[:, [0, 2, 5]] = rng.uniform(1.0, 3.0, (n, 3))
    s[:, [1, 3, 4]] = rng.uniform(-0.3, 0.3, (n, 3))
    return s


def _sym(m, a):
    return m.Sym3(*(m.arr(np.ascontiguousarray(a[:, i])) for i in range(6)))


def case_vec3(m, rng):
    a, b = _v3(m, _rand(rng, N, 3)), _v3(m, _rand(rng, N, 3))
    return a.cross(b), a.dot(b), a.normalize(), a.length(), a.min(b), (a - b).abs()


def case_quat(m, rng):
    q1, q2 = _q(m, _unit_quat(rng, N)), _q(m, _unit_quat(rng, N))
    v = _v3(m, _rand(rng, N, 3))
    return (q1.mul(q2), q1.rotate(v), q1.rotate_inverse(v), q1.to_matrix(),
            q1.mul(q2).normalize(), q1.conjugate())


def case_mat3(m, rng):
    rows = _rand(rng, N, 9) + np.tile(np.eye(3, dtype=np.float32).reshape(9) * 2, (N, 1))
    mat = m.Mat3(_v3(m, rows[:, 0:3]), _v3(m, rows[:, 3:6]), _v3(m, rows[:, 6:9]))
    v = _v3(m, _rand(rng, N, 3))
    return (mat.inverse(), mat.matmul(mat.transpose()), mat.transform(v),
            mat.transform_transpose(v), mat.determinant(), m.Mat3.cross_matrix(v))


def case_sym3(m, rng):
    s = _sym(m, _spd(rng, N))
    r = _q(m, _unit_quat(rng, N)).to_matrix()
    v = _v3(m, _rand(rng, N, 3))
    return (s.inverse(), s.rotation_sandwich(r), s.skew_sandwich(v), s.transform(v),
            s.vector_sandwich(v), s.determinant(), s.to_matrix())


def case_sym2(m, rng):
    a = _rand(rng, N, 3)
    s = m.Sym2(m.arr(a[:, 0] + 2.0), m.arr(a[:, 1] * 0.3), m.arr(a[:, 2] + 2.0))
    v = m.Vec2(m.arr(_rand(rng, N)), m.arr(_rand(rng, N)))
    return s.inverse(), s.transform(v), (s + s).inverse()


def case_integrate_orientation(m, rng):
    omega = _rand(rng, N, 3, lo=-8.0, hi=8.0)
    omega[:4] = 0.0  # |omega| = 0 keeps the orientation
    return m.integrate_orientation(_q(m, _unit_quat(rng, N)), _v3(m, omega), np.float32(1 / 240))


def case_orthonormal_basis(m, rng):
    n = rng.normal(size=(N, 3))
    n[:3] = [[0, 0, 1], [0, 0, -1], [0, 1, 0]]
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    return m.build_orthonormal_basis(_v3(m, n))


def case_springiness(m, rng):
    s = m.SpringSettings.make(m.arr(_rand(rng, N, lo=5.0, hi=60.0)),
                              m.arr(_rand(rng, N, lo=0.1, hi=2.0)))
    return s, m.compute_springiness(s, np.float32(1 / 240))


def case_compact_true(m, rng):
    mask = m.arr(rng.uniform(size=200) < 0.3)
    small, big = m.compact_true(mask, 32, fill=7), m.compact_true(mask, 256)
    return small[0], small[1], big[0], big[1]


def case_gather_rows(m, rng):
    tree = dict(p=_v3(m, _rand(rng, N, 3)), k=m.arr(rng.integers(0, 9, N).astype(np.int32)),
                b=m.arr(rng.uniform(size=N) < 0.5), w=m.arr(_rand(rng, N, 4)))
    idx = m.arr(rng.integers(0, N, 100).astype(np.int32))
    if m is TORCH:
        idx = idx.long()
    return m.gather_rows(tree, idx)


def case_body_buffer(m, rng):
    """Handle recycling: removed slots are handed out again, and the device snapshot of
    statics, kinematics and dynamics with shape-derived inertia matches field for field."""
    b = m.bodies
    buf = b.BodyBuffer(16)
    sphere, box = m.shapes.Sphere(0.5), m.shapes.Box(0.5, 0.3, 0.2)
    handles = [buf.add(b.StaticDescription(position=(0.0, -0.5, 0.0), shape=0))]
    for i in range(9):
        pos = tuple(float(x) for x in _rand(rng, 3))
        handles.append(buf.add(b.BodyDescription.dynamic(
            pos, 1 + i % 2, 1.0 + i, sphere if i % 2 == 0 else box)))
    handles.append(buf.add(b.BodyDescription.kinematic((0.0, 3.0, 0.0), 1)))
    for h in (3, 7, 5):
        buf.remove(h)
    for i in range(2):
        handles.append(buf.add(b.BodyDescription.dynamic((float(i), 2.0, 0.0), 2, 2.0, box)))
    state = buf.device() if m is JAX else buf.device("cpu")
    return np.array(handles + [buf.count], np.int32), state


def _body_state(m, rng):
    """A BodyState of dynamic, kinematic, static and sleeping bodies (JAX BodyBuffer
    layout), as the JAX package builds it and carried across for the port."""
    buf = jbodies.BodyBuffer(N)
    for f, a in dict(px=_rand(rng, N), py=_rand(rng, N), pz=_rand(rng, N),
                     vx=_rand(rng, N), vy=_rand(rng, N), vz=_rand(rng, N),
                     wx=_rand(rng, N, lo=-6, hi=6), wy=_rand(rng, N, lo=-6, hi=6),
                     wz=_rand(rng, N, lo=-6, hi=6), inv_mass=_rand(rng, N, lo=0.5, hi=2)).items():
        setattr(buf, f, a)
    buf.qx, buf.qy, buf.qz, buf.qw = _unit_quat(rng, N).T.copy()
    buf.ixx, buf.iyx, buf.iyy, buf.izx, buf.izy, buf.izz = _spd(rng, N).T.copy()
    buf.kind = rng.choice([jbodies.KIND_DYNAMIC] * 6 + [jbodies.KIND_KINEMATIC,
                                                        jbodies.KIND_STATIC], N).astype(np.int32)
    buf.awake = rng.uniform(size=N) < 0.85
    st = jax.tree_util.tree_map(np.asarray, buf.device())
    return st if m is JAX else _to_torch(st, "cpu")


def case_integrator(m, rng, angular_mode):
    st = _body_state(m, rng)
    if m is JAX:
        st = jax.tree_util.tree_map(jnp.asarray, st)
    cfg = m.integrator.IntegratorConfig(gravity=(0.0, -10.0, 0.0), angular_mode=angular_mode,
                                        linear_damping=0.1, angular_damping=0.2)
    v = m.integrator.integrate_velocities(st, cfg, np.float32(1 / 240))
    p = m.integrator.integrate_poses(v, cfg, np.float32(1 / 240))
    return v.vel, v.omega, p.pos, p.orn, p.omega


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
PARAMS = [pytest.param(name, {}, id=name) for name in CASES if name != "integrator"] + [
    pytest.param("integrator", {"angular_mode": mode}, id=f"integrator-mode{mode}")
    for mode in (0, 1, 2)
]


def _leaves(x):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, torch.Tensor):
        yield x.numpy()
    else:
        yield np.asarray(x)


@pytest.mark.parametrize("name,kw", PARAMS)
def test_math_matches_jax(name, kw):
    want = list(_leaves(CASES[name](JAX, np.random.default_rng(17), **kw)))
    got = list(_leaves(CASES[name](TORCH, np.random.default_rng(17), **kw)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(w.dtype), w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
