"""Whole-step checks of the PyTorch port against the JAX package on the CPU.

The scene is the 24-body sphere/box pile of ``tests/test_pallas_sweep.py`` with sleep on.
The JAX package steps it 10 frames; that state is carried across (numpy) and one step of
each stage runs in both packages. On the CPU the JAX package solves through XLA, whose
slice order is the page-execution order that the port's K1 walks, so one solve agrees to
1e-5; over 20 frames f32 reordering grows chaotically in a stacked pile, and both are held
to the envelope the JAX package holds its own XLA and kernel paths to (5e-3 max, 1e-4
median, ``tests/test_pallas_sweep.py``)."""
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
import bepuphysics2_tpu.simulation as jsim
from bepuphysics2_tpu.collision import broadphase as jbroad
from bepuphysics2_tpu.collision import narrowphase as jnarrow
from bepuphysics2_tpu.collision import pairstore as jstore
from bepuphysics2_tpu.shapes import bounds as jbounds
from bepuphysics2_tpu.sleep import wake_touched as jwake
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.integrator as tintegrator
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.collision import broadphase, narrowphase, pairstore
from bepuphysics2_tpu_torch.interop import shapes_from_numpy, state_from_numpy, state_to_numpy
from bepuphysics2_tpu_torch.shapes import bounds
from bepuphysics2_tpu_torch.sleep import wake_touched
from bepuphysics2_tpu_torch.solver.solve import solve_all
from bepuphysics2_tpu_torch.utils.vec import Vec3

DT = 1 / 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pile(mod):
    kw = dict(device="cpu") if mod is tbp else {}
    sim = mod.Simulation(mod.SimConfig(body_capacity=64, max_pairs=256, substeps=2,
                                       num_colors=4, velocity_iterations=2, enable_sleep=True),
                         **kw)
    ground = sim.add_shape(mod.Box(20.0, 0.5, 20.0))
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = mod.Sphere(0.5), mod.Box(0.4, 0.4, 0.4)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    rng = np.random.default_rng(11)
    for i in range(24):
        x, z = rng.uniform(-1.2, 1.2, 2)
        desc = (ss, 1.0, s) if i % 2 == 0 else (bs, 1.0, b)
        sim.add_body(mod.BodyDescription.dynamic((x, 0.6 + 0.85 * (i // 8), z), *desc))
    return sim


def _positions(sim):
    sim._sync_from_device()
    return np.stack([sim._host.px, sim._host.py, sim._host.pz])


def _port_config(cfg):
    """The JAX SimConfig's fields as the port's SimConfig."""
    return tsim.SimConfig(**dict(vars(cfg), integrator=tintegrator.IntegratorConfig(
        **vars(cfg.integrator))))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _present(sim):
    return tuple(sorted({int(t) for t in sim.shapes.types if t >= 0}))


# Carried states: frame 10 (the pile still falling and admitting pairs) and frame 130
# (settled, with a body asleep and its pairs banked in the store).
FRAMES = (10, 130)


@pytest.fixture(scope="module")
def jax_pile():
    """The JAX pile: at each of FRAMES its state and that state stepped once more by the
    JAX step, and its positions after 20 frames."""
    sim = _pile(jbp)
    out = dict(config=sim.config, present=_present(sim))
    for frame in range(1, max(FRAMES) + 1):
        sim.timestep(DT)
        if frame in FRAMES:
            s = _np(sim.state)
            nxt, _ = jsim._step_donated(jax.tree_util.tree_map(jnp.asarray, s),
                                        sim.shapes.device(), {}, jnp.float32(DT), sim.config,
                                        out["present"])
            out[frame] = (s, _np(nxt))
        if frame == 20:
            out["p20"] = _positions(sim)
    out["shapes"] = _np(sim.shapes.device())
    return out


@pytest.fixture(scope="module")
def port_p20():
    sim = _pile(tbp)
    sim.run(20, DT)
    return _positions(sim), sim.state_hash()


def _jax_stages(state, shapes, config, present):
    """The JAX store path of ``_step_impl`` up to the solve."""
    b = state.bodies
    dt = jnp.float32(DT)
    lo, hi = jbounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, dt,
                                         spec_min=b.spec_margin_min)
    has, big = b.shape >= 0, jnp.float32(3.0e38)
    lo = lo.where(has, JVec3.full(has.shape, big, big, big))
    hi = hi.where(has, JVec3.full(has.shape, -big, -big, -big))
    pairs = jbroad.brute_force(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs)
    churn, dead, repair = config.store_caps()
    store, ovf, demand, active = jstore.update(
        state.store, b.kind, b.awake, b.collision_group, lo, hi, pairs.a, pairs.b,
        pairs.valid, jnp.ones_like(pairs.valid), config.num_colors,
        jnp.zeros(config.body_capacity + 1, jnp.int32), churn, dead, repair)
    ps, imp, _ = jnarrow.narrow_phase_store(b, shapes, store, active, dt,
                                            present_types=present)
    return dict(lo=lo, hi=hi, pairs=pairs, store=store, active=active, ps=ps, imp=imp,
                bodies=jwake(b, ps))


def _port_stages(state, shapes, config, present):
    """The same stages through the port."""
    b = state.bodies
    lo, hi = bounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, DT,
                                        spec_min=b.spec_margin_min)
    has, big = b.shape >= 0, 3.0e38
    lo = lo.where(has, Vec3.full(has.shape, big, big, big))
    hi = hi.where(has, Vec3.full(has.shape, -big, -big, -big))
    pairs = broadphase.brute_force(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs)
    churn, dead, repair = config.store_caps()
    store, ovf, demand, active = pairstore.update(
        state.store, b.kind, b.awake, b.collision_group, lo, hi, pairs.a, pairs.b,
        pairs.valid, torch.ones_like(pairs.valid), config.num_colors,
        torch.zeros(config.body_capacity + 1, dtype=torch.int32), churn, dead, repair)
    ps, imp, _ = narrowphase.narrow_phase_store(b, shapes, store, active, float(np.float32(DT)),
                                                present_types=present)
    return dict(lo=lo, hi=hi, pairs=pairs, store=store, active=active, ps=ps, imp=imp,
                bodies=wake_touched(b, ps))


def _leaves(x):
    if isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, torch.Tensor):
        yield x.numpy()
    else:
        yield np.asarray(x)


def _check(got, want, tol):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(w.dtype), w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("frame", FRAMES)
def test_each_stage_of_one_step_matches_jax(jax_pile, frame):
    jcfg, present = jax_pile["config"], jax_pile["present"]
    cfg = _port_config(jcfg)
    before, after = jax_pile[frame]
    if frame == max(FRAMES):
        kind, awake = before.bodies.kind, before.bodies.awake
        assert ((kind == 1) & ~awake).any()  # the sleeping path is exercised
    jstate = jax.tree_util.tree_map(jnp.asarray, before)
    jshapes = jax.tree_util.tree_map(jnp.asarray, jax_pile["shapes"])
    want = _np(jax.jit(_jax_stages, static_argnums=(2, 3))(jstate, jshapes, jcfg, present))
    shapes = shapes_from_numpy(jax_pile["shapes"], "cpu")
    tstate = state_from_numpy(before, "cpu")
    got = _port_stages(tstate, shapes, cfg, present)

    _check((got["lo"], got["hi"]), (want["lo"], want["hi"]), 1e-5)  # bounds
    _check(got["pairs"], want["pairs"], 0)  # broad phase: exact
    assert int(want["pairs"].valid.sum()) > 10
    gs, ws = got["store"], want["store"]
    for f in ("live", "body_a", "body_b", "color", "page_color", "jacv", "used", "hpos"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(), getattr(ws, f), err_msg=f)
    np.testing.assert_array_equal(got["active"].numpy(), want["active"])
    _check(got["ps"], want["ps"], 1e-5)  # prestep
    _check(got["imp"], want["imp"], 1e-5)  # carried warm start
    _check(got["bodies"].awake, want["bodies"].awake, 0)

    # The solve: the port's K1 path on the port's own stages, against the JAX step.
    bodies, imps, *_ = solve_all(got["bodies"], [], {}, cfg.integrator, cfg.solve_config(),
                                 float(np.float32(DT)),
                                 store_bank=dict(store=got["store"], ps=got["ps"],
                                                 imp=got["imp"], active=got["active"]))
    jb = after.bodies
    for f in ("pos", "orn", "vel", "omega"):
        _check(getattr(bodies, f), getattr(jb, f), 1e-5)
    moved = np.abs(np.stack(jb.pos) - np.stack(before.bodies.pos)).max()
    assert moved > 1e-5


@pytest.mark.parametrize("frame", FRAMES)
def test_one_windowed_solve_matches_jax(jax_pile, frame):
    """The windowed branch (K2's plain version) from a carried state, against the JAX
    package's windowed branch with its kernel in interpret mode: the same layout, slice
    order and row math, so one solve agrees to 1e-5."""
    from bepuphysics2_tpu.solver import solve as jsolve

    jcfg, present = jax_pile["config"], jax_pile["present"]
    cfg = _port_config(jcfg)
    before, _ = jax_pile[frame]
    jstate = jax.tree_util.tree_map(jnp.asarray, before)
    jshapes = jax.tree_util.tree_map(jnp.asarray, jax_pile["shapes"])
    js = jax.jit(_jax_stages, static_argnums=(2, 3))(jstate, jshapes, jcfg, present)
    jbank = dict(store=js["store"], ps=js["ps"], imp=js["imp"], active=js["active"])
    jscfg = dataclasses.replace(jcfg.solve_config(), backend="pallas_win")
    want_b, want_imp, _, want_ovf, _, _, want_d = jsolve._solve_store_fast(
        js["bodies"], jbank, jcfg.integrator, jscfg, jnp.float32(DT), True, use_win=True)

    got = _port_stages(state_from_numpy(before, "cpu"), shapes_from_numpy(jax_pile["shapes"], "cpu"),
                       cfg, present)
    bodies, imps, _, ovf, _, _, demand = solve_all(
        got["bodies"], [], {}, cfg.integrator,
        dataclasses.replace(cfg.solve_config(), backend="pallas_win"), float(np.float32(DT)),
        store_bank=dict(store=got["store"], ps=got["ps"], imp=got["imp"], active=got["active"]))
    for f in ("pos", "orn", "vel", "omega"):
        _check(getattr(bodies, f), _np(getattr(want_b, f)), 1e-5)
    _check(imps[0], _np(want_imp[0]), 1e-5)
    assert bool(ovf) == bool(want_ovf)
    np.testing.assert_array_equal(demand.numpy(), np.asarray(want_d))
    moved = np.abs(np.stack(_np(want_b.pos)) - np.stack(before.bodies.pos)).max()
    assert moved > 1e-5


@pytest.mark.parametrize("frame", FRAMES)
def test_port_step_matches_jax_step(jax_pile, frame):
    cfg = _port_config(jax_pile["config"])
    before, want = jax_pile[frame]
    state, _ = tsim.step(state_from_numpy(before, "cpu"),
                         shapes_from_numpy(jax_pile["shapes"], "cpu"), {}, DT, cfg,
                         jax_pile["present"])
    got = state_to_numpy(state)
    for f in ("pos", "orn", "vel", "omega"):
        _check(getattr(got.bodies, f), getattr(want.bodies, f), 1e-5)
    np.testing.assert_array_equal(got.bodies.awake, want.bodies.awake)
    np.testing.assert_array_equal(got.bodies.sleep_island, want.bodies.sleep_island)
    for f in ("live", "color", "page_color", "active_prev", "feature"):
        np.testing.assert_array_equal(getattr(got.store, f), getattr(want.store, f))
    for f in ("imp_pen", "imp_tx", "imp_ty", "imp_tw"):
        _check(getattr(got.store, f), getattr(want.store, f), 1e-5)


def test_twenty_frames_stay_in_the_reference_envelope(jax_pile, port_p20):
    diff = np.abs(port_p20[0] - jax_pile["p20"])
    assert diff.max() < 5e-3, diff.max()
    assert np.median(diff) < 1e-4
    assert np.isfinite(port_p20[0]).all() and (port_p20[0][1][1:25] > -0.2).all()


def test_same_scene_twice_is_bit_identical(port_p20):
    sim = _pile(tbp)
    sim.run(20, DT)
    np.testing.assert_array_equal(_positions(sim), port_p20[0])
    assert sim.state_hash() == port_p20[1]


def test_port_never_imports_jax():
    pkg = Path(tbp.__file__).parent
    names = [m.name for m in pkgutil.walk_packages([str(pkg)], prefix="bepuphysics2_tpu_torch.")]
    assert len(names) > 15
    code = ("import sys, importlib\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.startswith('bepuphysics2_tpu.') or m == 'bepuphysics2_tpu')\n"
            "assert not bad, bad\n")
    root = pkg.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
    for src in pkg.rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            assert not (words[:1] == ["import"] and words[1].split(".")[0] == "jax"), src
            assert not (words[:1] == ["from"] and words[1].split(".")[0] == "jax"), src


def _tiny(**cfg):
    sim = tbp.Simulation(tbp.SimConfig(body_capacity=8, max_pairs=64, substeps=1, **cfg),
                         device="cpu")
    sim.add_body(tbp.BodyDescription.dynamic((0, 1.0, 0), sim.add_shape(tbp.Sphere(0.5)),
                                             1.0, tbp.Sphere(0.5)))
    return sim


def test_simulation_defaults_to_the_card():
    """The entry point runs on the card unless the caller asks for the CPU; naming the
    device needs no card."""
    assert tbp.Simulation(tbp.SimConfig(body_capacity=8, max_pairs=64)).device.type == "cuda"
    assert _tiny().device.type == "cpu"


@pytest.mark.parametrize("case,item", [
    ("jax_shape", "not a shape of the port"), ("windowed_compound", "queue 3"),
])
def test_unported_paths_are_refused_by_name(case, item):
    """A scene or call the port cannot carry raises, naming the ROADMAP item; it is never
    solved on a path the port does not have."""
    with pytest.raises(NotImplementedError, match=item):
        if case == "jax_shape":
            _tiny().add_shape(jbp.Cylinder(0.5, 1.0))
        elif case == "windowed_compound":
            sim = _tiny(solver_backend="pallas_win")
            box = sim.add_shape(tbp.Box(0.5, 0.5, 0.5))
            sim.add_body(tbp.BodyDescription.kinematic((0, -0.5, 0), sim.add_shape(
                tbp.Compound.build([(box, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))]))))
            sim.timestep(DT)  # the JAX package's windowed general path fails on it


@pytest.mark.parametrize("case", ["sweep_broadphase", "grid_broadphase", "legacy_cache"])
def test_formerly_refused_configurations_run(case):
    """The configurations the port refused until the legacy path and the last two broad
    phases were ported: a step runs, the ball falls, nothing overflows."""
    sim = _tiny(**dict(sweep_broadphase=dict(broadphase="sweep"),
                       grid_broadphase=dict(broadphase="grid"),
                       legacy_cache=dict(use_pair_store=False))[case])
    sim.run(3, DT)
    assert sim.get_body(0)[0][1] < 1.0 and not bool(sim.last_diag.overflow)
    assert (sim.state.store is None) == (case == "legacy_cache")


def test_formerly_refused_sharded_solve_runs_on_one_rank(tmp_path):
    """``solve_all`` with a process group (JAX ``axis_name``) solves on a one-rank gloo
    group (in a spawned rank, so this process keeps no process group)."""
    from torch_ranks import run_ranks

    sim = _tiny()
    sim.run(1, DT)
    st = sim.state
    res = run_ranks(1, {"sharded": dict(
        state=st._replace(store=None), shapes=sim.shapes.device("cpu"), banks={},
        present=sim._present_types(), config=sim.config, dt=DT, frames=2)}, tmp_path)
    assert res[0]["sharded"]["bodies"][-1].pos.y[0] < float(st.bodies.pos.y[0])


def _egg_support(params, d):
    """Support of the ellipsoid with semi-axes params[..., 0:3], no margin."""
    a, b, c = params[..., 0], params[..., 1], params[..., 2]
    inv = 1.0 / torch.sqrt((a * d.x) ** 2 + (b * d.y) ** 2 + (c * d.z) ** 2).clamp_min(1e-12)
    return Vec3(a * a * d.x * inv, b * b * d.y * inv, c * c * d.z * inv), torch.zeros_like(a)


@pytest.mark.parametrize("shape", ["cylinder", "triangle", "convex_hull", "custom"])
def test_ported_shapes_register_and_step(shape, request):
    """Each shape the port now carries registers, and a body of it falls onto a box and
    comes to rest on it on the CPU (the generic GJK/MPR narrow phase for the cylinder, the
    hull and the custom shape, the box-triangle tester for the triangle). The custom type
    is unregistered afterwards, so that a later module of the same worker finds its ids
    free."""
    from bepuphysics2_tpu_torch.shapes.custom import CUSTOM_SUPPORTS

    def custom():
        tid = tbp.register_custom_shape(_egg_support)
        request.addfinalizer(lambda: CUSTOM_SUPPORTS.pop(tid))
        return tbp.CustomShape(tid, (0.4, 0.25, 0.3), 0.4, (0.03, 0.05, 0.04))

    sim = tbp.Simulation(tbp.SimConfig(body_capacity=8, max_pairs=64, substeps=4), device="cpu")
    ground = sim.add_shape(tbp.Box(5.0, 0.5, 5.0))
    sim.add_static(tbp.StaticDescription(position=(0, -0.5, 0), shape=ground))
    obj = {"cylinder": lambda: tbp.Cylinder(0.4, 0.3),
           "triangle": lambda: tbp.Triangle((-0.5, 0.0, -0.4), (0.5, 0.0, -0.4), (0.0, 0.0, 0.6)),
           "convex_hull": lambda: tbp.ConvexHull.from_points(
               np.random.default_rng(3).normal(size=(20, 3)) * 0.3),
           "custom": custom}[shape]()
    body = sim.add_body(tbp.BodyDescription.dynamic((0, 0.8, 0), sim.add_shape(obj), 1.0, obj))
    sim.run(60, DT)
    pos, _, vel, _ = sim.get_body(body)
    assert int(sim.last_diag.contact_count) > 0 and not bool(sim.last_diag.overflow)
    assert -0.05 < pos[1] < 0.8 and np.linalg.norm(vel) < 0.5, (pos, vel)


# --- slice 2: grid2, the windowed solve, migrate, reconfigure, autosize ------------------

@pytest.fixture(scope="module")
def windowed_runs():
    """The pile through the port with the windowed path forced (K2's plain version), with
    the brute-force broad phase for 20 frames and with grid2 for 3 and 20 frames, and the
    K1 path with grid2 for 3 frames."""
    def sim(**kw):
        out = _pile(tbp)
        out.config = dataclasses.replace(out.config, **kw)
        return out

    win, win_grid, k1_grid = (sim(solver_backend="pallas_win"),
                              sim(solver_backend="pallas_win", broadphase="grid2"),
                              sim(broadphase="grid2"))
    win.run(20, DT)
    win_grid.run(3, DT)
    k1_grid.run(3, DT)
    out = dict(win20=_positions(win), win_grid3=_positions(win_grid), k1_grid3=_positions(k1_grid))
    win_grid.run(17, DT)
    out.update(win_grid20=_positions(win_grid), diag=win_grid.last_diag)
    return out


def test_windowed_path_over_twenty_frames(windowed_runs, port_p20):
    """The windowed path against the K1 path. K2 regroups rows by (color, Morton block),
    so the Gauss-Seidel order differs: with the same broad phase the two are held to the
    JAX package's envelope for its own windowed kernel against its XLA path
    (``tests/test_pallas_sweep.py``: 2e-3 after 3 frames; 2e-2 max, 1e-3 median after
    20). grid2 lists the same pairs as brute force in another order, so the store gives
    them other slots and colors; in this pile (bodies overlap at the start) that alone
    moves a box by ~0.14 after 20 frames, in the JAX package as in the port, so the
    grid2 run is held to the K1 path with grid2 over 3 frames, and to physical bounds
    over 20."""
    diff = np.abs(windowed_runs["win20"] - port_p20[0])
    assert diff.max() < 2e-2, diff.max()
    assert np.median(diff) < 1e-3
    diff3 = np.abs(windowed_runs["win_grid3"] - windowed_runs["k1_grid3"])
    assert diff3.max() < 2e-3, diff3.max()
    pw = windowed_runs["win_grid20"]
    assert np.isfinite(pw).all() and (pw[1][1:25] > -0.2).all()
    d = windowed_runs["diag"]
    assert not bool(d.overflow) and int(d.demand[tsim.D_ENTRIES]) > 0  # grid2 ran


@pytest.mark.parametrize("new_cap,new_page", [(128, 16), (32, 8), (64, 8)])
def test_migrate_matches_jax(new_cap, new_page):
    """``pairstore.migrate`` against the JAX package's, exactly, on the store of
    ``tests/test_pairstore.py``'s migrate case: grow, shrink and page change."""
    import test_pairstore as tp
    from bepuphysics2_tpu_torch.interop import _to_torch

    store = jstore.PairStore.empty(64, tp.NB, 8)
    ca = jnp.arange(0, 24, 2, dtype=jnp.int32)
    store, _, _, _ = tp._update(store, (ca, ca + 1), churn=16)
    rng = np.random.default_rng(4)
    live = np.asarray(store.live)
    pen = np.where(live[:, None], rng.uniform(0, 1, (64, 4)), 0).astype(np.float32)
    feat = np.where(live[:, None], rng.integers(0, 90, (64, 4)), -1).astype(np.int32)
    store = store._replace(imp_pen=jnp.asarray(pen), feature=jnp.asarray(feat),
                           imp_tx=jnp.asarray(pen[:, 1]), active_prev=store.live)
    kind = np.ones(tp.NB, np.int32)
    kind[::5] = 3  # static endpoints claim no color
    want = jstore.migrate(store, new_cap, tp.NB, new_page, tp.C, kind=kind)
    got = pairstore.migrate(_to_torch(_np(store), "cpu"), new_cap, tp.NB, new_page, tp.C,
                            kind=kind)
    assert int(np.asarray(want.live).sum()) >= min(12, new_cap // 2)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def _pair_records(store):
    live = np.nonzero(store.live.numpy())[0]
    return {(int(store.body_a[i]), int(store.body_b[i])): (
        tuple(store.imp_pen[i].tolist()), float(store.imp_tx[i]), float(store.imp_ty[i]),
        float(store.imp_tw[i]), tuple(store.feature[i].tolist()), int(store.color[i]))
        for i in live}


def test_reconfigure_migrates_the_store_and_keeps_body_capacity():
    sim = _pile(tbp)
    sim.run(12, DT)
    before = _pair_records(sim.state.store)
    assert len(before) > 20 and any(r[0][0] > 0 for r in before.values())
    sim.reconfigure(max_pairs=512, num_colors=4)
    store = sim.state.store
    assert store.capacity == 512 and store.page == 32
    assert _pair_records(store) == before  # every live pair's impulses, features, color
    with pytest.raises(ValueError, match="body_capacity"):
        sim.reconfigure(body_capacity=128)
    sim.run(2, DT)
    assert not bool(sim.last_diag.overflow)


def test_autosize_clears_overflow():
    """The pile on a pair world too small for it overflows; autosize reads the demand,
    grows max_pairs (migrating the store) and the overflow clears."""
    sim = _pile(tbp)
    sim.config = dataclasses.replace(sim.config, max_pairs=32)
    sim.run(10, DT)
    assert bool(sim.last_diag.overflow)
    out = sim.autosize(DT, probe_steps=4)
    assert not out["overflow"] and not bool(sim.last_diag.overflow)
    assert sim.config.max_pairs >= int(out["demand"][tsim.D_LIVE])
    assert sim.state.store.capacity == sim.config.store_layout()[0]
    assert sim.config.wide_cap_rows == 256 and out["rounds"] >= 1
    live = _pair_records(sim.state.store)
    assert len(live) > 40 and any(r[0][0] > 0 for r in live.values())


@pytest.mark.parametrize("frame", FRAMES)
def test_contacts_and_live_pairs_match_jax(jax_pile, frame):
    """``contacts()`` and ``live_contact_pairs()`` read from the same carried JAX state in
    both packages: the same records in the same order, the same pairs."""
    carried = jax_pile[frame][0]
    jax_sim, port_sim = _pile(jbp), _pile(tbp)
    jax_sim._state = jax.tree_util.tree_map(jnp.asarray, carried)
    jax_sim._dirty = False
    port_sim._state = state_from_numpy(carried, "cpu")
    port_sim._dirty = False
    want, got = jax_sim.contacts(), port_sim.contacts()
    assert len(want) > 0 and got == want
    assert port_sim.live_contact_pairs() == jax_sim.live_contact_pairs()
