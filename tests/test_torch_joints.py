"""The port's joints and coloring against the JAX package's, on seeded numpy inputs.

- Every two-body and one-body type's ``warm_start`` / ``solve`` on random poses,
  inertias, velocities and impulses, its prestep drawn field by field from its
  ``FIELDS``, half the rows inactive: 1e-5 (the same float32 formulas). Rows 20-27 take
  identity orientations and exact axes, so that every branch that picks by a comparison
  (the antiparallel twist axes of ``_quat_between`` and ``_twist_jacobian``, the identity
  rotation of ``_axis_angle``, coincident centers, opposite motor axes) runs well inside
  its side; ``test_branch_helpers_match_jax`` holds those helpers on each branch directly.
- ``AreaConstraint`` and ``VolumeConstraint`` on a ``MultiBodyContext``: 1e-5.
- The registry: all 30 names, with the JAX package's bank layouts.
- ``JointTypeStore``: the packed host banks of the same ``add`` / ``remove`` sequence are
  equal exactly for every type, and ``unpack_fields`` round-trips.
- ``color_constraints_incremental`` (carried colors, segments with caps, another bank's
  claims) and ``jacobi_valence_kary``: integer bookkeeping and whole-number counts, equal
  exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bepuphysics2_tpu.constraints import joints as jjoints
from bepuphysics2_tpu.constraints.contact import BodyVel as JBodyVel
from bepuphysics2_tpu.constraints.contact import GatheredInertia as JInertia
from bepuphysics2_tpu.constraints.joints import angular as jangular
from bepuphysics2_tpu.constraints.joints.base import unpack_fields as junpack
from bepuphysics2_tpu.solver import coloring as jcoloring
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Sym3 as JSym3, Vec3 as JVec3

from bepuphysics2_tpu_torch.constraints import joints as tjoints
from bepuphysics2_tpu_torch.constraints.contact import BodyVel, GatheredInertia
from bepuphysics2_tpu_torch.constraints.joints import angular as tangular
from bepuphysics2_tpu_torch.constraints.joints.base import unpack_fields
from bepuphysics2_tpu_torch.solver import coloring
from bepuphysics2_tpu_torch.utils.vec import Quat, Sym3, Vec3

TOL = 1e-5
N = 200
DT = np.float32(1 / 60) / np.float32(4)
KINEMATIC = slice(0, N // 10)  # rows whose both bodies have no inertia
IDENTITY = slice(20, 28)  # rows on identity orientations (the branch rows)
TWO_BODY = [t.name for t in jjoints.TWO_BODY_TYPES]
PACKAGES = ((jjoints, JVec3, JQuat, JSym3, JInertia, JBodyVel, jnp.asarray),
            (tjoints, Vec3, Quat, Sym3, GatheredInertia, BodyVel, torch.from_numpy))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit(rng, n, k):
    v = rng.normal(size=(n, k))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _context_arrays(rng):
    """Seeded numpy draws of both sides' poses, inertias and velocities, and the mask: B's
    pose near A's, as a joint holds it."""
    sides = []
    for _ in range(2):
        q = _unit(rng, N, 4)
        q[IDENTITY] = (0, 0, 0, 1)
        im = rng.uniform(0.2, 2.0, N)
        ii = np.zeros((N, 6))
        ii[:, [0, 2, 5]] = rng.uniform(0.5, 3.0, (N, 3))
        ii[:, [1, 3, 4]] = rng.uniform(-0.1, 0.1, (N, 3))
        im[KINEMATIC] = 0.0
        ii[KINEMATIC] = 0.0
        sides.append(dict(pos=rng.uniform(-2, 2, (N, 3)), q=q, im=im, ii=ii,
                          lin=rng.uniform(-1, 1, (N, 3)), ang=rng.uniform(-2, 2, (N, 3))))
    sides[1]["pos"] = sides[0]["pos"] + rng.uniform(-0.6, 0.6, (N, 3))
    sides[1]["pos"][20:24] = sides[0]["pos"][20:24]  # coincident centers
    return sides, rng.uniform(size=N) < 0.5


def _context(arrays, V, Q, S, Inertia, Vel, Ctx, conv):
    sides, active = arrays

    def cols(a, T):
        return T(*(conv(np.ascontiguousarray(a[:, i], np.float32)) for i in range(a.shape[1])))

    parts = []
    for d in sides:
        parts += [cols(d["pos"], V), cols(d["q"], Q),
                  Inertia(conv(d["im"].astype(np.float32)), cols(d["ii"], S)),
                  Vel(cols(d["lin"], V), cols(d["ang"], V))]
    return Ctx(*parts, conv(active))


def _qmul(a, b):
    ax, ay, az, aw = a.T
    bx, by, bz, bw = b.T
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], 1)


def _conj(q):
    return q * (-1, -1, -1, 1)


def _rot(q, v):
    u, w = q[:, :3], q[:, 3:]
    t = 2 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _nudge(rng, q, angle=0.05):
    """``q`` turned by up to ``angle`` about a random axis (exact on the branch rows)."""
    half = rng.uniform(0, angle / 2, (N, 1))
    d = np.concatenate([_unit(rng, N, 3) * np.sin(half), np.cos(half)], 1)
    d[IDENTITY] = (0, 0, 0, 1)
    return _qmul(d, q)


def _near(rng, v, scale=0.05):
    out = v + rng.uniform(-scale, scale, v.shape)
    out[IDENTITY] = v[IDENTITY]
    return out


def _prestep(rng, cls, arrays):
    """A prestep of N rows, field by field from the class's FIELDS, drawn near the rest
    state of the context's poses (``arrays``), as a joint of a running scene holds it:
    errors of a few hundredths, so impulses stay of order one and float32 rounding below
    the tolerance. Servo and motor limits are small enough to bind on some rows."""
    (sa, sb), _ = arrays
    qa, qb, pa, pb = sa["q"], sb["q"], sa["pos"], sb["pos"]
    rel = _qmul(_conj(qb), qa)  # A's frame seen from B's
    name, cols, f = cls.name, [], {}
    for field, kind in cls.FIELDS:
        if kind == "spring":
            v = np.stack([rng.uniform(10, 60, N) * 2 * np.pi, rng.uniform(0.5, 2, N) * 2], 1)
        elif kind == "servo":
            v = np.stack([rng.uniform(0.2, 2, N), rng.uniform(0, 0.2, N),
                          rng.uniform(0.5, 20, N)], 1)
        elif kind == "motor":  # maximum force, damping (1 / softness)
            v = np.stack([rng.uniform(0.5, 20, N), rng.uniform(10, 1000, N)], 1)
        elif kind == "quat":
            if field == "local_basis_b":
                v = _nudge(rng, _qmul(rel, f["local_basis_a"]))
                v[IDENTITY] = (0, 0, 0, 1)  # B's twist axis +z against A's -z
            elif field in ("local_orientation", "target_relative_rotation"):
                v = _nudge(rng, _qmul(_conj(qa), qb))
            elif field == "target_orientation":
                v = _nudge(rng, qa)
            else:
                v = _unit(rng, N, 4)
                v[IDENTITY] = (1, 0, 0, 0) if name.startswith("twist") else (0, 0, 0, 1)
        elif field in ("local_offset_b",) and name not in ("distance_servo", "distance_limit"):
            anchor = pa + _rot(qa, f.get("local_offset_a", np.zeros((N, 3))))
            v = _near(rng, _rot(_conj(qb), anchor - pb))
        elif field == "local_offset" and name == "weld":
            v = _near(rng, _rot(_conj(qa), pb - pa))
        elif field == "target":
            v = _near(rng, pa + _rot(qa, f["local_offset"]))
        elif kind == "vec3" and ("axis" in field or "normal" in field or "direction" in field):
            v = _unit(rng, N, 3)
            if field in ("local_hinge_axis_b", "axis_local_b", "local_axis_b") and name not in (
                    "linear_axis_motor", "linear_axis_limit"):
                first = f.get("local_hinge_axis_a", f.get("axis_local_a", f.get("local_axis_a")))
                if first is None:  # swivel: B's hinge axis across A's swivel axis
                    first = np.cross(f["local_swivel_axis_a"], v)
                v = _rot(rel, first) if first is not None else v
                v = _near(rng, v / np.linalg.norm(v, axis=1, keepdims=True))
                if name == "twist_motor":
                    v[IDENTITY] = (0, 0, -1)  # opposite axes: the jacobian's fallback
            if name == "twist_motor" and field == "local_axis_a":
                v[IDENTITY] = (0, 0, 1)
            if name in ("swing_limit", "angular_swivel_hinge", "swivel_hinge"):
                v[IDENTITY] = (0, 1, 0)  # parallel axes: the cross product's fallback
            v = v / np.linalg.norm(v, axis=1, keepdims=True)
        elif kind == "vec3":
            v = rng.uniform(-0.5, 0.5, (N, 3))
        else:
            v = _scalar(rng, name, field, f, arrays)
        f[field] = v
        cols.append(v.reshape(N, -1))
    p = np.concatenate(cols, 1)
    assert p.shape[1] == cls.N_PRESTEP
    return p.astype(np.float32), cls.N_IMPULSE


def _scalar(rng, name, field, f, arrays):
    """A scalar field near the context's current value (limits straddle it)."""
    (sa, sb), _ = arrays
    if name.startswith("center_distance"):
        now = np.linalg.norm(sb["pos"] - sa["pos"], axis=1)
    elif name.startswith("distance"):
        now = np.linalg.norm(sb["pos"] + _rot(sb["q"], f["local_offset_b"]) - sa["pos"]
                             - _rot(sa["q"], f["local_offset_a"]), axis=1)
    elif field.startswith("target_scaled"):
        p = _mb_bodies(arrays)
        ab, ac = p[1]["pos"] - p[0]["pos"], p[2]["pos"] - p[0]["pos"]
        now = (np.linalg.norm(np.cross(ab, ac), axis=1) if name == "area"
               else np.einsum("ij,ij->i", np.cross(ab, ac), p[3]["pos"] - p[0]["pos"]))
    elif field == "minimum_dot":
        return rng.uniform(0.95, 1.0, (N, 1))
    else:  # angles, offsets along an axis, velocities, ratios: small around zero
        now = np.zeros(N)
    now = now[:, None]
    if field.startswith("minimum"):
        return now - rng.uniform(-0.02, 0.1, (N, 1))
    if field.startswith("maximum"):
        return now + rng.uniform(-0.02, 0.1, (N, 1))
    if field in ("target_velocity", "velocity_scale"):
        return rng.uniform(-1, 1, (N, 1))
    return now + rng.uniform(-0.05, 0.05, (N, 1))


def _flat(res, solve):
    out = []
    for part in (res if solve else (None, *res)):
        if part is None:
            continue
        if isinstance(part, (list, tuple)) and not hasattr(part, "linear"):
            for dv in part:
                out += [*dv.linear, *dv.angular]
        elif hasattr(part, "linear"):
            out += [*part.linear, *part.angular]
        else:
            out.append(part)
    return [np.asarray(x) for x in out]


def _run_both(name, fn, seed, context):
    cls_j = jjoints.JOINT_TYPES[name]
    arrays = _context_arrays(np.random.default_rng(seed + 200))
    p, n_imp = _prestep(np.random.default_rng(seed), cls_j, arrays)
    imp = np.random.default_rng(seed + 100).uniform(0, 0.5, (N, n_imp)).astype(np.float32)
    out = []
    for mod, V, Q, S, Inertia, Vel, conv in PACKAGES:
        ctx = context(arrays, mod, V, Q, S, Inertia, Vel, conv)
        cls = mod.JOINT_TYPES[name]
        if fn == "solve":
            res = cls.solve(conv(p), conv(imp), ctx, float(DT), float(1 / DT))
        else:
            res = cls.warm_start(conv(p), conv(imp), ctx)
        out.append(_flat(res, fn == "solve"))
    return out


def _check(want, got):
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
        assert np.isfinite(w[N // 10:]).all()  # every row with a body of inertia
    assert max(np.nanmax(np.abs(w)) for w in want) > 1e-2  # the records move something


@pytest.mark.parametrize("name", TWO_BODY)
@pytest.mark.parametrize("fn", ["warm_start", "solve"])
def test_joint_matches_jax(name, fn):
    seed = 10 * TWO_BODY.index(name) + 10 + (fn == "solve")
    want, got = _run_both(name, fn, seed, lambda a, mod, *t: _context(a, *t[:5], mod.JointContext,
                                                                      t[5]))
    _check(want, got)


def _mb_bodies(arrays):
    """Four bodies of a multi-body record: the two sides' draws, and two more made from
    them (positions shifted, velocities swapped, inverse masses of other rows, so that
    every record has a body of mass)."""
    (a, b), _ = arrays
    return [a, b, dict(a, pos=a["pos"] + (0.7, -0.3, 0.5), lin=b["lin"], im=np.roll(a["im"], 50)),
            dict(b, pos=b["pos"] + (-0.4, 0.9, 0.2), lin=a["lin"], im=np.roll(b["im"], 50))]


def _mb_context(arrays, mod, V, Q, S, Inertia, Vel, conv):
    """A MultiBodyContext over ``_mb_bodies``, inverse masses unscaled."""
    f = lambda x: conv(np.ascontiguousarray(x, np.float32))
    bodies = _mb_bodies(arrays)
    active = arrays[1]
    return mod.MultiBodyContext(
        pos=[V(*(f(d["pos"][:, i]) for i in range(3))) for d in bodies],
        vel=[Vel(V(*(f(d["lin"][:, i]) for i in range(3))), V(*(f(d["ang"][:, i])
                                                                 for i in range(3))))
             for d in bodies],
        inv_mass=[f(d["im"]) for d in bodies], active=conv(active))


@pytest.mark.parametrize("name", ["area", "volume"])
@pytest.mark.parametrize("fn", ["warm_start", "solve"])
def test_multibody_joint_matches_jax(name, fn):
    seed = {"area": 500, "volume": 600}[name] + (fn == "solve")
    want, got = _run_both(name, fn, seed, _mb_context)
    _check(want, got)


def test_branch_helpers_match_jax():
    """``_quat_between``, ``_axis_angle`` and ``signed_angle_difference`` on inputs chosen
    on each side of each branch: antiparallel unit vectors off the z axis and on it (the
    perpendicular's fallback), general ones; the identity rotation (the axis fallback),
    negative and positive w; differences across the wrap at +-pi."""
    v1 = np.array([[0.6, 0.8, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.48, 0.6, 0.64],
                   [1.0, 0.0, 0.0]], np.float32)
    v2 = np.concatenate([-v1[:3], [[0.0, 0.6, 0.8], [0.0, 1.0, 0.0]]]).astype(np.float32)
    q = np.array([[0, 0, 0, 1], [0, 0, 0, -1], [0.1, -0.2, 0.3, -0.9], [0.5, 0.5, -0.5, 0.5],
                  [1, 0, 0, 0]], np.float32)
    a = np.array([3.0, -3.0, 0.5, -2.5, 1.0], np.float32)
    b = np.array([-3.0, 3.0, 0.4, 2.5, -2.0], np.float32)
    out = []
    for mod, V, Q, conv in ((jangular, JVec3, JQuat, jnp.asarray),
                            (tangular, Vec3, Quat, torch.from_numpy)):
        vec = lambda x: V(*(conv(np.ascontiguousarray(x[:, i])) for i in range(3)))
        qb = mod._quat_between(vec(v1), vec(v2))
        axis, angle = mod._axis_angle(Q(*(conv(np.ascontiguousarray(q[:, i])) for i in range(4))))
        wrap = mod.signed_angle_difference(conv(a), conv(b))
        out.append([np.asarray(x) for x in (*qb, *axis, angle, wrap)])
    for g, w in zip(out[1], out[0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    np.testing.assert_allclose(out[0][:4][3][:3], 0.0, atol=1e-6)  # antiparallel: half turns
    np.testing.assert_array_equal(np.stack(out[0][4:7], 1)[0], [1.0, 0.0, 0.0])


def test_joint_registry_matches_jax():
    """All 30 names are ported classes with the JAX package's bank layouts."""
    assert list(tjoints.JOINT_TYPES) == list(jjoints.JOINT_TYPES)
    assert len(tjoints.JOINT_TYPES) == 30
    for name, jcls in jjoints.JOINT_TYPES.items():
        cls = tjoints.JOINT_TYPES[name]
        assert cls.__name__ == jcls.__name__ and cls.name == name
        for attr in ("N_PRESTEP", "N_IMPULSE", "FIELDS"):
            assert getattr(cls, attr) == getattr(jcls, attr), (name, attr)
        assert getattr(cls, "N_BODIES", 2) == getattr(jcls, "N_BODIES", 2)
        assert callable(cls.warm_start) and callable(cls.solve) and callable(cls.pack)
    assert tjoints.ONE_BODY_NAMES == jjoints.ONE_BODY_NAMES


def _desc(mod, cls, rng):
    """A description of ``cls`` with every field drawn from ``rng``."""
    kw = {}
    for name, kind in cls.FIELDS:
        if kind == "vec3":
            kw[name] = tuple(float(x) for x in rng.uniform(-1, 1, 3))
        elif kind == "quat":
            kw[name] = tuple(float(x) for x in _unit(rng, 1, 4)[0])
        elif kind == "scalar":
            kw[name] = float(rng.uniform(-1, 1))
        elif kind == "spring":
            kw.update(spring_frequency=float(rng.uniform(10, 40)),
                      spring_damping=float(rng.uniform(0.5, 2)))
        elif kind == "servo":
            kw["servo"] = mod.ServoSettingsDesc(*(float(x) for x in rng.uniform(0.1, 9, 3)))
        else:
            kw["motor"] = mod.MotorSettingsDesc(*(float(x) for x in rng.uniform(0.1, 9, 2)))
    return mod.make_description(cls.name, **kw)


def _fill(mod):
    rng = np.random.default_rng(7)
    stores = {}
    for name, cls in mod.JOINT_TYPES.items():
        nb = 1 if name in mod.ONE_BODY_NAMES else getattr(cls, "N_BODIES", 2)
        st = mod.JointTypeStore(cls, 4)
        for k in range(7):  # past the capacity: the bank grows
            st.add([nb * k + j for j in range(nb)], _desc(mod, cls, rng))
        st.remove(3)
        st.add(list(range(40, 40 + nb)), _desc(mod, cls, rng))
        stores[name] = st
    return stores


def test_joint_type_store_packing_matches_jax():
    want, got = _fill(jjoints), _fill(tjoints)
    assert sorted(want) == sorted(got)
    for name in want:
        w, g = want[name], got[name]
        assert (g.capacity, g.count, g.n_bodies) == (w.capacity, w.count, w.n_bodies)
        for f in ("bodies", "valid", "prestep", "impulse", "color"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
        for k in range(g.capacity):
            if g.valid[k]:
                plain = lambda d: {k: getattr(v, "__dict__", v) for k, v in d.items()}
                assert plain(unpack_fields(g.cls, g.prestep[k])) == plain(
                    junpack(w.cls, w.prestep[k]))
        dev = g.device("cpu")
        for f in ("bodies", "valid", "prestep", "impulse"):
            np.testing.assert_array_equal(dev[f].numpy(), np.asarray(w.device()[f]))
    assert got["area"].bodies.shape[1] == 3 and got["volume"].bodies.shape[1] == 4


def _coloring_inputs(seed, m=240, nb=60, k=2):
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, nb, (m, k)).astype(np.int32)
    dyn = rng.uniform(size=(m, k)) < 0.85
    valid = rng.uniform(size=m) < 0.8
    prev = rng.integers(-1, 5, m).astype(np.int32)
    # Carried colors must be conflict-free per (dynamic body, color): keep a valid set.
    seen = set()
    for r in range(m):
        c = prev[r]
        keys = {(int(refs[r, j]), int(c)) for j in range(k) if dyn[r, j]}
        if c >= 0 and (keys & seen or not valid[r]):
            prev[r] = -1
        elif c >= 0:
            seen |= keys
    base = np.zeros(nb + 1, np.int32)
    base[rng.choice(nb, nb // 5, replace=False)] = rng.integers(1, 16, nb // 5)
    return refs, dyn, valid, prev, base, nb


@pytest.mark.parametrize("case", ["segments", "no_segments", "tight_caps"])
def test_color_constraints_incremental_matches_jax_exactly(case):
    refs, dyn, valid, prev, base, nb = _coloring_inputs({"segments": 3, "no_segments": 4,
                                                         "tight_caps": 5}[case])
    C = 4
    segments = {"segments": [(0, 160, 48), (160, 80, 24)], "no_segments": None,
                "tight_caps": [(0, 160, 8), (160, 80, 8)]}[case]
    kw = dict(segments=segments, rounds=3, churn_cap=64)
    jc, jr = jcoloring.color_constraints_incremental(
        jnp.asarray(refs), jnp.asarray(dyn), jnp.asarray(valid), jnp.asarray(prev), nb, C,
        base_used=jnp.asarray(base), **kw)
    t = torch.from_numpy
    tc, tr = coloring.color_constraints_incremental(t(refs), t(dyn), t(valid), t(prev), nb, C,
                                                    base_used=t(base), **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jc = np.asarray(jc)
    assert (jc[valid] < C).any()
    if case == "tight_caps":
        assert (jc[valid] == C).sum() > 100  # capacity demotions to the Jacobi bucket
    else:
        assert (jc[valid & (prev < 0)] < C).any()  # new rows won colors


def test_jacobi_valence_kary_matches_jax_exactly():
    refs, dyn, valid, _, base, nb = _coloring_inputs(6)
    in_j = valid & (np.random.default_rng(8).uniform(size=valid.shape[0]) < 0.3)
    extra = np.random.default_rng(9).integers(0, 3, nb + 1).astype(np.float32)
    want = jcoloring.jacobi_valence_kary(jnp.asarray(refs), jnp.asarray(dyn),
                                         jnp.asarray(in_j), nb, extra_counts=jnp.asarray(extra))
    t = torch.from_numpy
    got = coloring.jacobi_valence_kary(t(refs), t(dyn), t(in_j), nb, extra_counts=t(extra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) > 1).any()
