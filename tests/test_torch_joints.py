"""The port's joints and coloring against the JAX package's, on seeded numpy inputs.

- ``BallSocket`` and ``SwingLimit`` ``warm_start`` / ``solve`` on random poses, inertias,
  velocities and impulses, half the rows inactive: 1e-5 (the same float32 formulas).
- ``JointTypeStore``: the packed host banks of the same ``add`` / ``remove`` sequence are
  equal exactly, and ``unpack_fields`` round-trips.
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
from bepuphysics2_tpu.constraints.joints.base import unpack_fields as junpack
from bepuphysics2_tpu.solver import coloring as jcoloring
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Sym3 as JSym3, Vec3 as JVec3

from bepuphysics2_tpu_torch.constraints import joints as tjoints
from bepuphysics2_tpu_torch.constraints.contact import BodyVel, GatheredInertia
from bepuphysics2_tpu_torch.constraints.joints.base import unpack_fields
from bepuphysics2_tpu_torch.solver import coloring
from bepuphysics2_tpu_torch.utils.vec import Quat, Sym3, Vec3

TOL = 1e-5
N = 200
DT = np.float32(1 / 60) / np.float32(4)


def _context(rng, V, Q, S, Inertia, Vel, Ctx, conv):
    """A JointContext of N records from seeded numpy (the same draws for both packages)."""
    def cols(a, T):
        return T(*(conv(a[:, i].copy()) for i in range(a.shape[1])))

    sides = []
    for _ in range(2):
        pos = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
        q = rng.normal(size=(N, 4))
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        im = rng.uniform(0.2, 2.0, N).astype(np.float32)
        ii = np.zeros((N, 6), np.float32)
        ii[:, [0, 2, 5]] = rng.uniform(0.5, 3.0, (N, 3))
        ii[:, [1, 3, 4]] = rng.uniform(-0.1, 0.1, (N, 3))
        im[: N // 10] = 0.0  # kinematic ends
        ii[: N // 10] = 0.0
        lin = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
        ang = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
        sides.append((cols(pos, V), cols(q, Q), Inertia(conv(im), cols(ii, S)),
                      Vel(cols(lin, V), cols(ang, V))))
    active = conv(rng.uniform(size=N) < 0.5)
    return Ctx(*sides[0], *sides[1], active)


def _prestep(rng, name):
    if name == "ball_socket":
        off = rng.uniform(-0.5, 0.5, (N, 6))
        spring = np.stack([rng.uniform(10, 60, N) * 2 * np.pi, rng.uniform(0.5, 2, N) * 2], 1)
        return np.concatenate([off, spring], 1).astype(np.float32), 3
    axes = rng.normal(size=(N, 6))
    axes[:, :3] /= np.linalg.norm(axes[:, :3], axis=1, keepdims=True)
    axes[:, 3:] /= np.linalg.norm(axes[:, 3:], axis=1, keepdims=True)
    axes[: N // 8, 3:] = axes[: N // 8, :3]  # parallel axes: the basis fallback jacobian
    min_dot = rng.uniform(-0.5, 0.9, (N, 1))
    spring = np.stack([rng.uniform(10, 60, N) * 2 * np.pi, rng.uniform(0.5, 2, N) * 2], 1)
    return np.concatenate([axes, min_dot, spring], 1).astype(np.float32), 1


@pytest.mark.parametrize("name", ["ball_socket", "swing_limit"])
@pytest.mark.parametrize("fn", ["warm_start", "solve"])
def test_joint_matches_jax(name, fn):
    seed = {"ball_socket": 1, "swing_limit": 2}[name] * 10 + (fn == "solve")
    p, n_imp = _prestep(np.random.default_rng(seed), name)
    imp = np.random.default_rng(seed + 100).uniform(0, 0.5, (N, n_imp)).astype(np.float32)
    out = []
    for mod, V, Q, S, Inertia, Vel, conv in (
            (jjoints, JVec3, JQuat, JSym3, JInertia, JBodyVel, jnp.asarray),
            (tjoints, Vec3, Quat, Sym3, GatheredInertia, BodyVel, torch.from_numpy)):
        ctx = _context(np.random.default_rng(seed + 200), V, Q, S, Inertia, Vel,
                       mod.JointContext, conv)
        cls = mod.JOINT_TYPES[name]
        if fn == "solve":
            res = cls.solve(conv(p), conv(imp), ctx, float(DT), float(1 / DT))
        else:
            res = cls.warm_start(conv(p), conv(imp), ctx)
        flat = []
        for part in res if fn == "solve" else (None, *res):
            if part is None:
                continue
            if hasattr(part, "linear"):
                flat += [*part.linear, *part.angular]
            else:
                flat.append(part)
        out.append([np.asarray(x) for x in flat])
    want, got = out
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert max(np.abs(w).max() for w in want) > 1e-2  # the records move something


def _fill(mod):
    rng = np.random.default_rng(7)
    stores = {}
    for name in ("ball_socket", "swing_limit"):
        st = mod.JointTypeStore(mod.JOINT_TYPES[name], 4)
        for k in range(7):  # past the capacity: the bank grows
            if name == "ball_socket":
                desc = mod.make_description(name, local_offset_a=tuple(rng.uniform(-1, 1, 3)),
                                            local_offset_b=tuple(rng.uniform(-1, 1, 3)),
                                            spring_frequency=float(rng.uniform(10, 40)))
            else:
                desc = mod.make_description(name, axis_local_a=(0, 1, 0),
                                            axis_local_b=tuple(rng.normal(size=3)),
                                            minimum_dot=float(rng.uniform(-1, 1)))
            st.add([2 * k, 2 * k + 1], desc)
        st.remove(3)
        st.add([40, 41], desc)
        stores[name] = st
    return stores


def test_joint_type_store_packing_matches_jax():
    want, got = _fill(jjoints), _fill(tjoints)
    for name in want:
        w, g = want[name], got[name]
        assert (g.capacity, g.count) == (w.capacity, w.count)
        for f in ("bodies", "valid", "prestep", "impulse", "color"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
        for k in range(g.capacity):
            if g.valid[k]:
                assert unpack_fields(g.cls, g.prestep[k]) == junpack(w.cls, w.prestep[k])
        dev = g.device("cpu")
        for f in ("bodies", "valid", "prestep", "impulse"):
            np.testing.assert_array_equal(dev[f].numpy(), np.asarray(w.device()[f]))


def test_unported_joint_types_are_refused():
    assert len(tjoints.JOINT_TYPES) == len(jjoints.JOINT_TYPES) == 30
    assert sorted(tjoints.JOINT_TYPES) == sorted(jjoints.JOINT_TYPES)
    for name in ("weld", "hinge", "volume"):
        with pytest.raises(NotImplementedError, match="item 16"):
            tjoints.JointTypeStore(tjoints.JOINT_TYPES[name], 8)


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
