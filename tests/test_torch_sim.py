"""Whole-step checks of the PyTorch port against the JAX package on the CPU.

The scene is the 24-body sphere/box pile of ``tests/test_pallas_sweep.py`` with sleep on.
The JAX package steps it 10 frames; that state is carried across (numpy) and one step of
each stage runs in both packages. On the CPU the JAX package solves through XLA, whose
slice order is the page-execution order that the port's K1 walks, so one solve agrees to
1e-5; over 20 frames f32 reordering grows chaotically in a stacked pile, and both are held
to the envelope the JAX package holds its own XLA and kernel paths to (5e-3 max, 1e-4
median, ``tests/test_pallas_sweep.py``)."""
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


def _pile(mod, **kw):
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
    sim = tbp.Simulation(tbp.SimConfig(body_capacity=8, max_pairs=64, substeps=1, **cfg))
    sim.add_body(tbp.BodyDescription.dynamic((0, 1.0, 0), sim.add_shape(tbp.Sphere(0.5)),
                                             1.0, tbp.Sphere(0.5)))
    return sim


@pytest.mark.parametrize("case,item", [
    ("capsule", "item 17"), ("compound", "item 18"), ("jax_shape", "item 17"),
    ("grid_broadphase", "item 12"), ("ccd", "item 19"), ("joint", "items 15-16"),
    ("autosize", "item 11"), ("ray_cast", "item 20"),
])
def test_unported_paths_are_refused_by_name(case, item):
    """A scene or call the port cannot carry raises, naming the ROADMAP item; it is never
    solved on a path the port does not have."""
    with pytest.raises(NotImplementedError, match=item):
        if case == "capsule":
            _tiny().add_shape(tbp.Capsule(0.5, 1.0))
        elif case == "compound":
            _tiny().add_shape(tbp.Compound.build([(0, (0.0, 0.0, 0.0))]))
        elif case == "jax_shape":
            _tiny().add_shape(jbp.Cylinder(0.5, 1.0))
        elif case == "grid_broadphase":
            _tiny(broadphase="grid2").timestep(DT)
        elif case == "ccd":
            _tiny(max_ccd_pairs=8).timestep(DT)
        elif case == "joint":
            _tiny().add_constraint("ball_socket", [0, 1])
        elif case == "autosize":
            _tiny().autosize()
        else:
            _tiny().ray_cast((0, 5, 0), (0, -1, 0))
