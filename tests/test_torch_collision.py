"""The port's collision stages against the JAX package's, on the same inputs: bounds,
brute-force broad phase, the three analytic testers, the pair store update and the
store narrow phase. Scenes come from the JAX package (a 24-body sphere/box pile stepped
10 frames) and are carried across as numpy arrays.

Tolerances: the broad phase and the pair store are integer bookkeeping and agree exactly;
bounds, manifolds and the prestep agree to 1e-5 (the same float32 formulas, evaluated by
XLA's and PyTorch's CPU kernels)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu.collision import broadphase as jbroad
from bepuphysics2_tpu.collision import narrowphase as jnarrow
from bepuphysics2_tpu.collision import pairstore as jstore
from bepuphysics2_tpu.collision import testers as jtesters
from bepuphysics2_tpu.shapes import bounds as jbounds
from bepuphysics2_tpu.shapes.registry import ShapeRegistry as JRegistry
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Vec3 as JVec3

from bepuphysics2_tpu_torch.collision import broadphase, narrowphase, pairstore, testers
from bepuphysics2_tpu_torch.interop import _to_torch, shapes_from_numpy, state_from_numpy
from bepuphysics2_tpu_torch.shapes import bounds
from bepuphysics2_tpu_torch.utils.vec import Quat, Vec3

DT = np.float32(1 / 60)
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(x):
    if isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, torch.Tensor):
        yield x.numpy()
    else:
        yield np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(w.dtype), w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def _registry():
    reg = JRegistry(16)
    reg.add(jbp.Box(20.0, 0.5, 20.0))
    reg.add(jbp.Sphere(0.5))
    reg.add(jbp.Box(0.4, 0.3, 0.6))
    reg.add(jbp.Sphere(0.25))
    return reg


@pytest.fixture(scope="module")
def pile():
    """The 24-body sphere/box pile on a static box, sleep on, stepped 10 frames in the
    JAX package; returns its config, numpy state and numpy ShapeData."""
    sim = jbp.Simulation(jbp.SimConfig(body_capacity=64, max_pairs=256, substeps=2,
                                       num_colors=4, velocity_iterations=2, enable_sleep=True))
    ground = sim.add_shape(jbp.Box(20.0, 0.5, 20.0))
    sim.add_static(jbp.StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = jbp.Sphere(0.5), jbp.Box(0.4, 0.4, 0.4)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    rng = np.random.default_rng(11)
    for i in range(24):
        x, z = rng.uniform(-1.2, 1.2, 2)
        desc = (ss, 1.0, s) if i % 2 == 0 else (bs, 1.0, b)
        sim.add_body(jbp.BodyDescription.dynamic((x, 0.6 + 0.85 * (i // 8), z), *desc))
    sim.run(10, float(DT))
    return sim.config, _np(sim.state), _np(sim.shapes.device())


def _random_bodies(rng, n, spread, rows):
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    orn = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    omega = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    shape = rng.choice(rows, n).astype(np.int32)
    spec = rng.uniform(0.0, 0.2, n).astype(np.float32)
    return pos, orn, vel, omega, shape, spec


def _bounds_both(rng, n, spread, rows=(-1, 0, 1, 2, 3)):
    reg = _registry()
    sd = _np(reg.device())
    pos, orn, vel, omega, shape, spec = _random_bodies(rng, n, spread, rows)
    cols = lambda a, V: V(*(a[:, i].copy() for i in range(a.shape[1])))
    want = jbounds.compute_body_bounds(
        cols(pos, JVec3), cols(orn, JQuat), cols(vel, JVec3), cols(omega, JVec3),
        jnp.asarray(shape), jax.tree_util.tree_map(jnp.asarray, sd), DT, spec_min=spec)
    t = torch.from_numpy
    tcols = lambda a, V: V(*(t(a[:, i].copy()) for i in range(a.shape[1])))
    got = bounds.compute_body_bounds(
        tcols(pos, Vec3), tcols(orn, Quat), tcols(vel, Vec3), tcols(omega, Vec3), t(shape),
        shapes_from_numpy(sd, "cpu"), DT, spec_min=t(spec))
    return got, want


def test_bounds_match_jax():
    got, want = _bounds_both(np.random.default_rng(1), 200, spread=2.0)
    _close(got, want)


@pytest.mark.parametrize("max_pairs", [512, 8])
def test_brute_force_matches_jax_exactly(max_pairs):
    rng = np.random.default_rng(2)
    n = 96
    _, (lo, hi) = _bounds_both(rng, n, spread=3.0, rows=(1, 2, 3))  # no ground slab, no shapeless body
    kind = rng.choice([0, 1, 1, 1, 2, 3], n).astype(np.int32)
    awake = rng.uniform(size=n) < 0.8
    group = rng.choice([0, 0, 0, 1, 2], n).astype(np.int32)
    want = _np(jbroad.brute_force(lo, hi, jnp.asarray(kind), jnp.asarray(awake),
                                  jnp.asarray(group), max_pairs))
    t = torch.from_numpy
    got = broadphase.brute_force(_to_torch(_np(lo), "cpu"), _to_torch(_np(hi), "cpu"),
                                 t(kind), t(awake), t(group), max_pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.asarray(w).dtype), w)
    assert int(want.valid.sum()) > 0
    assert bool(want.overflow) == (max_pairs == 8)


def _relative_poses(rng, n, scale):
    """Pair poses spread from deep overlap to separation: centers at distances that
    bracket the touching distance ``scale``."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = scale * np.concatenate([rng.uniform(0.1, 0.9, n // 3),  # deep
                                   rng.uniform(0.97, 1.03, n // 3),  # touching
                                   rng.uniform(1.1, 2.0, n - 2 * (n // 3))])  # separated
    pos_ab = (d * dist[:, None]).astype(np.float32)
    q = lambda: rng.normal(size=(n, 4))
    qa, qb = q(), q()
    qa[: n // 6] = [0, 0, 0, 1]  # aligned boxes: face-face manifolds with ties
    qb[: n // 6] = [0, 0, 0, 1]
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return pos_ab, norm(qa), norm(qb)


@pytest.mark.parametrize("pair", ["sphere_sphere", "sphere_box", "box_box"])
def test_tester_matches_jax(pair):
    rng = np.random.default_rng({"sphere_sphere": 3, "sphere_box": 4, "box_box": 5}[pair])
    n = 300
    sphere = np.zeros((n, 12), np.float32)
    sphere[:, 0] = rng.uniform(0.2, 0.8, n)
    box = np.zeros((n, 12), np.float32)
    box[:, :3] = rng.uniform(0.2, 0.8, (n, 3))
    pa, pb = {"sphere_sphere": (sphere, sphere), "sphere_box": (sphere, box),
              "box_box": (box, box)}[pair]
    reach = pa[:, :3].max(1) + pb[:, :3].max(1)
    pos_ab, qa, qb = _relative_poses(rng, n, reach.mean())

    def run(mod, V, Q, conv):
        cols = lambda a, T: T(*(conv(a[:, i].copy()) for i in range(a.shape[1])))
        args = dict(pos_ab=cols(pos_ab, V), orn_a=cols(qa, Q), orn_b=cols(qb, Q),
                    params_a=conv(pa), params_b=conv(pb))
        if pair == "sphere_sphere":
            return mod.sphere_sphere(args["pos_ab"], args["params_a"], args["params_b"])
        if pair == "sphere_box":
            return mod.sphere_box(args["pos_ab"], args["orn_b"], args["params_a"],
                                  args["params_b"])
        return mod.box_box(**args)

    want = _np(run(jtesters, JVec3, JQuat, jnp.asarray))
    got = run(testers, Vec3, Quat, torch.from_numpy)
    _close(got, want)
    depth = np.where(want.contact_mask, want.depth, np.nan)
    assert np.nanmax(depth) > 0.05 and np.nanmin(depth) < -0.05  # deep and separated


def _store_inputs(config, state, sd):
    """This frame's bounds and broad-phase pairs for the carried pile (JAX side)."""
    jst = jax.tree_util.tree_map(jnp.asarray, state)
    jsd = jax.tree_util.tree_map(jnp.asarray, sd)
    b = jst.bodies
    lo, hi = jbounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, jsd, DT,
                                         spec_min=b.spec_margin_min)
    has = b.shape >= 0
    big = jnp.float32(3.0e38)
    lo = lo.where(has, JVec3.full(has.shape, big, big, big))
    hi = hi.where(has, JVec3.full(has.shape, -big, -big, -big))
    pairs = jbroad.brute_force(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs)
    return jst, lo, hi, pairs


@pytest.fixture(scope="module")
def updated(pile):
    """One frame of pair-store maintenance on the carried pile, in both packages:
    ((jax store, overflow, demand, active), (port ...)) and the pile itself."""
    config, state, sd = pile
    jst, lo, hi, pairs = _store_inputs(config, state, sd)
    b = jst.bodies
    nb = config.body_capacity
    churn, dead, repair = config.store_caps()
    insertable = jnp.ones_like(pairs.valid)
    ext = jnp.zeros(nb + 1, jnp.int32)
    jupdate = jax.jit(jstore.update, static_argnums=(10, 12, 13, 14))
    jout = _np(jupdate(jst.store, b.kind, b.awake, b.collision_group, lo, hi, pairs.a,
                             pairs.b, pairs.valid, insertable, config.num_colors, ext,
                             churn, dead, repair))
    tst = state_from_numpy(state, "cpu")
    tb = tst.bodies
    t = lambda x: torch.from_numpy(np.array(x))
    tout = pairstore.update(tst.store, tb.kind, tb.awake, tb.collision_group,
                            _to_torch(_np(lo), "cpu"), _to_torch(_np(hi), "cpu"), t(pairs.a),
                            t(pairs.b), t(pairs.valid), t(insertable), config.num_colors, t(ext),
                            churn, dead, repair)
    return jout, tout, pile


@pytest.mark.parametrize("fn,cap", [("exec_order", 0), ("jacobi_counts", 8),
                                    ("jacobi_counts", 512), ("store_claims", 0)])
def test_store_helpers_match_jax(fn, cap):
    """``exec_order``, ``jacobi_counts`` (at a ``cap`` below and above the Jacobi row
    count, so both branches of the JAX function run) and ``store_claims``, on seeded
    inputs: exact, since all three are integer bookkeeping or whole-number counts."""
    rng = np.random.default_rng(6)
    nb, colors, slots, page = 40, 4, 512, 32
    a = rng.integers(0, nb, slots).astype(np.int32)
    b = rng.integers(0, nb, slots).astype(np.int32)
    t = torch.from_numpy
    if fn == "exec_order":
        pc = rng.integers(-1, colors + 1, slots // page).astype(np.int32)
        jst = jstore.PairStore.empty(slots, nb, page)._replace(page_color=jnp.asarray(pc))
        tst = pairstore.PairStore.empty(slots, nb, page)._replace(page_color=t(pc))
        want, got = jstore.exec_order(jst, colors), pairstore.exec_order(tst, colors)
    elif fn == "jacobi_counts":
        jac = rng.uniform(size=slots) < 0.1
        want = jstore.jacobi_counts(jnp.asarray(a), jnp.asarray(b), jnp.asarray(jac), nb, cap)
        got = pairstore.jacobi_counts(t(a), t(b), t(jac), nb, cap)
    else:
        bodies = np.stack([a, b], 1)
        bodies[::7, 1] = nb + 3  # out-of-range ends clamp to the sink row
        col = rng.integers(-1, colors + 1, slots).astype(np.int32)
        valid = rng.uniform(size=slots) < 0.8
        want = jstore.store_claims(jnp.asarray(bodies), jnp.asarray(col), jnp.asarray(valid),
                                   nb, colors)
        got = pairstore.store_claims(t(bodies), t(col), t(valid), nb, colors)
    _close(got, _np(want), tol=0)
    assert any(np.asarray(w).any() for w in _leaves(_np(want)))


def _ht_triples(ht):
    ht = np.asarray(ht)
    return {tuple(r) for r in ht[ht[:, 2] >= 0].tolist()}


def test_pairstore_update_matches_jax(updated):
    (jst, jovf, jdem, jact), (tst, tovf, tdem, tact), (config, _, _) = updated
    for field in ("live", "body_a", "body_b", "color", "page_color", "jacv", "used",
                  "active_prev", "hpos", "feature", "imp_pen", "imp_tx", "imp_ty", "imp_tw"):
        np.testing.assert_array_equal(getattr(tst, field).numpy(), getattr(jst, field),
                                      err_msg=field)
    assert bool(tovf) == bool(jovf)
    np.testing.assert_array_equal(tdem.numpy(), jdem)
    np.testing.assert_array_equal(tact.numpy(), jact)
    # The hash table by lookup: every live slot is found under its own pair, in both.
    assert _ht_triples(tst.ht) == _ht_triples(jst.ht)
    live = np.nonzero(jst.live)[0]
    assert len(live) > 10 and (jst.color[live] < config.num_colors).any()
    for s in live:
        a, b = int(jst.body_a[s]), int(jst.body_b[s])
        hb = tst.ht.shape[0] // pairstore.LANES
        bucket = int(pairstore._hash_bucket(torch.tensor([a]), torch.tensor([b]), hb))
        lanes = tst.ht[bucket * pairstore.LANES:(bucket + 1) * pairstore.LANES].numpy()
        assert [a, b, s] in lanes.tolist()


def test_narrow_phase_store_matches_jax(updated):
    (jst, _, _, jact), _, (config, state, sd) = updated
    jbodies = jax.tree_util.tree_map(jnp.asarray, state.bodies)
    jsd = jax.tree_util.tree_map(jnp.asarray, sd)
    present = (0, 2)
    jps, jimp, _ = jnarrow.narrow_phase_store(
        jbodies, jsd, jax.tree_util.tree_map(jnp.asarray, jst), jnp.asarray(jact), DT,
        present_types=present)
    tps, timp, _ = narrowphase.narrow_phase_store(
        _to_torch(state.bodies, "cpu"), shapes_from_numpy(sd, "cpu"), _to_torch(jst, "cpu"),
        torch.from_numpy(np.array(jact)), DT, present_types=present)
    _close(tps, _np(jps))
    _close(timp, _np(jimp))
    assert int(np.asarray(jps.valid).sum()) > 10
