"""The legacy per-frame cache path of the PyTorch port (``SimConfig.use_pair_store=False``)
against the JAX package on the CPU.

The scene is the 24-body sphere/box pile of ``tests/test_torch_sim.py`` with sleep on
(sleep after 0.2 s, so that by frame 130 five bodies sleep and their pairs sit in the sleep
bank); a second scene adds one ball socket between two of its bodies. The JAX package
carries the pile 130 frames and the ball socket's 10 on its default (XLA) path; from the
carried states:

- stage by stage on the pile, the same inputs in both packages: bounds and the brute force, the
  per-frame records with their carried impulses and colors (the presorted join against
  the cache, and the sleep bank's), the wake, the solve against the JAX ``solve_all``
  with ``backend="pallas"`` (the layout the port's kernels run: slices of
  ``min(512, round_up(color capacity, 128))`` rows, the mega kernel in interpret mode),
  ``update_cache`` and ``retain_sleeping``: integers exactly, floats within 1e-5 (a body's
  vectors absolute and relative to their length, ``test_torch_general_win.py``);
- a whole port step against the JAX step, for both scenes (the ball socket's through the
  general path, K3's plain version beside the joint sweep, against the JAX package's XLA
  bucketed path, whose colors agree while no color fills its capacity): bodies within
  1e-5, the awake set exactly, the
  cache's keys, colors and validity exactly and its impulses within 1e-5, the sleep bank's
  keys exactly. Features are not compared: a box-box manifold's feature ids can differ in
  a near-tie that moves no contact (the JAX package's fused arithmetic against the
  port's).

Each JAX configuration compiles once: the carry's step, the stages and the Pallas solve.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu.collision import broadphase as jbroad
from bepuphysics2_tpu.collision import narrowphase as jnarrow
from bepuphysics2_tpu.shapes import bounds as jbounds
from bepuphysics2_tpu.sleep import wake_touched as jwake
from bepuphysics2_tpu.solver import solve as jsolve
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.collision import broadphase, narrowphase
from bepuphysics2_tpu_torch.interop import (
    joint_banks_from_numpy, shapes_from_numpy, state_from_numpy, state_to_numpy,
)
from bepuphysics2_tpu_torch.shapes import bounds
from bepuphysics2_tpu_torch.sleep import wake_touched
from bepuphysics2_tpu_torch.solver.solve import solve_all
from bepuphysics2_tpu_torch.utils.vec import Vec3

from test_torch_general_win import _close, _close_per_body
from test_torch_sim import _port_config

DT = 1 / 60
FRAMES = (10, 130)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def legacy_pile(mod, joint=False):
    """The 24-body pile on the legacy path, sleep after 0.2 s; ``joint``: a ball socket
    between bodies 1 and 2 (a sphere and a box)."""
    kw = dict(device="cpu") if mod is tbp else {}
    sim = mod.Simulation(mod.SimConfig(
        body_capacity=64, max_pairs=256, substeps=2, num_colors=4, velocity_iterations=2,
        enable_sleep=True, sleep_time=0.2, use_pair_store=False, joint_capacity=8), **kw)
    ground = sim.add_shape(mod.Box(20.0, 0.5, 20.0))
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = mod.Sphere(0.5), mod.Box(0.4, 0.4, 0.4)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    rng = np.random.default_rng(11)
    for i in range(24):
        x, z = rng.uniform(-1.2, 1.2, 2)
        desc = (ss, 1.0, s) if i % 2 == 0 else (bs, 1.0, b)
        sim.add_body(mod.BodyDescription.dynamic((x, 0.6 + 0.85 * (i // 8), z), *desc))
    if joint:
        sim.add_constraint("ball_socket", [1, 2], local_offset_a=(0.5, 0, 0),
                           local_offset_b=(-0.45, 0, 0))
    return sim


def _carry(joint, frames=FRAMES):
    """The JAX scene's states at ``frames`` and after one more JAX step each."""
    sim = legacy_pile(jbp, joint)
    out = dict(config=sim.config, shapes=_np(sim.shapes.device()),
               present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})),
               banks=_np({n: {k: v for k, v in st.device().items() if k != "impulse"}
                          for n, st in sim.joints.items() if st.count > 0}))
    for frame in range(1, max(frames) + 2):
        before = _np(sim.state) if frame - 1 in frames else None
        sim.timestep(DT)
        if before is not None:
            out[frame - 1] = (before, _np(sim.state))
    return out


@pytest.fixture(scope="module")
def carried():
    return {False: _carry(False), True: _carry(True, FRAMES[:1])}


def _jax_stages(state, shapes, banks, config, present):
    b = state.bodies
    dt = jnp.float32(DT)
    lo, hi = jbounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, dt,
                                         spec_min=b.spec_margin_min)
    has, big = b.shape >= 0, jnp.float32(3.0e38)
    lo = lo.where(has, JVec3.full(has.shape, big, big, big))
    hi = hi.where(has, JVec3.full(has.shape, -big, -big, -big))
    pairs = jbroad.brute_force(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs)
    ps, imp, pcolor, _ = jnarrow.narrow_phase(b, shapes, pairs, state.cache, dt,
                                              present_types=present, pairs_sorted=True,
                                              sleep_bank=state.sleep_cache)
    bodies = jwake(b, ps)
    jb = {n: dict(banks[n], impulse=state.joint_impulses[n], color=state.joint_colors[n])
          for n in banks}
    solved = jsolve.solve_all(bodies, [(ps, imp, pcolor)], jb, config.integrator,
                              dataclasses.replace(config.solve_config(), backend="pallas"), dt)
    cache = jnarrow.update_cache(ps, solved[1][0], config.body_capacity, solved[4][0],
                                 slot_live=pairs.valid)
    bank, rovfl = jnarrow.retain_sleeping(state.sleep_cache, cache, solved[0].kind,
                                          solved[0].awake, config.body_capacity)
    return dict(lo=lo, hi=hi, pairs=pairs, ps=ps, imp=imp, pcolor=pcolor, bodies=bodies,
                solved=solved, cache=cache, bank=bank, rovfl=rovfl)


_STAGES = jax.jit(_jax_stages, static_argnums=(3, 4))


def _port_stages(state, shapes, banks, config, present):
    b = state.bodies
    lo, hi = bounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, DT,
                                        spec_min=b.spec_margin_min)
    has, big = b.shape >= 0, 3.0e38
    lo = lo.where(has, Vec3.full(has.shape, big, big, big))
    hi = hi.where(has, Vec3.full(has.shape, -big, -big, -big))
    dt = float(np.float32(DT))
    pairs = broadphase.brute_force(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs)
    ps, imp, pcolor, _ = narrowphase.narrow_phase(b, shapes, pairs, state.cache, dt,
                                                  present_types=present, pairs_sorted=True,
                                                  sleep_bank=state.sleep_cache)
    bodies = wake_touched(b, ps)
    tb = {n: dict(banks[n], impulse=state.joint_impulses[n], color=state.joint_colors[n])
          for n in banks}
    solved = solve_all(bodies, [(ps, imp, pcolor)], tb, config.integrator,
                       config.solve_config(), dt)
    cache = narrowphase.update_cache(ps, solved[1][0], config.body_capacity, solved[4][0],
                                     slot_live=pairs.valid)
    bank, rovfl = narrowphase.retain_sleeping(state.sleep_cache, cache, solved[0].kind,
                                              solved[0].awake, config.body_capacity)
    return dict(lo=lo, hi=hi, pairs=pairs, ps=ps, imp=imp, pcolor=pcolor, bodies=bodies,
                solved=solved, cache=cache, bank=bank, rovfl=rovfl)


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _hold_tree(got, want, tol, what):
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        _close(a, b, tol, what)


def _cache_fields(got, want, what):
    for f in ("key", "color", "valid", "body_a", "body_b"):
        _close(getattr(got, f), getattr(want, f), 0, f"{what} {f}")
    for f in ("penetration", "twist"):
        _close(getattr(got, f), getattr(want, f), 1e-5, f"{what} {f}")
    _hold_tree(got.tangent, want.tangent, 1e-5, f"{what} tangent")


@pytest.mark.parametrize("frame", FRAMES)
def test_each_legacy_stage_matches_jax(carried, frame):
    joint = False
    run = carried[joint]
    jcfg, present = run["config"], run["present"]
    cfg = _port_config(jcfg)
    before, _ = run[frame]
    if frame == max(FRAMES):
        assert ((before.bodies.kind == 1) & ~before.bodies.awake).any()
        assert before.sleep_cache.valid.any()  # the sleep bank holds rows
    want = _np(_STAGES(jax.tree_util.tree_map(jnp.asarray, before),
                       jax.tree_util.tree_map(jnp.asarray, run["shapes"]),
                       jax.tree_util.tree_map(jnp.asarray, run["banks"]), jcfg, present))
    tbanks = joint_banks_from_numpy(run["banks"], "cpu")
    got = _port_stages(state_from_numpy(before, "cpu"), shapes_from_numpy(run["shapes"], "cpu"),
                       tbanks, cfg, present)

    _hold_tree((got["lo"], got["hi"]), (want["lo"], want["hi"]), 1e-5, "bounds")
    _hold_tree(got["pairs"], want["pairs"], 0, "broad phase")
    assert int(want["pairs"].valid.sum()) > 10
    for f in ("body_a", "body_b", "valid", "contact_mask"):
        _close(getattr(got["ps"], f), getattr(want["ps"], f), 0, f"prestep {f}")
    # Records' fields where a record is valid, contacts' where a contact is live.
    rec, con = want["ps"].valid, want["ps"].contact_mask
    for f, m in (("normal", rec), ("offset_b", rec), ("friction", rec), ("offset_a", con),
                 ("depth", con)):
        for g, w in zip(_leaves(getattr(got["ps"], f)), jax.tree_util.tree_leaves(
                getattr(want["ps"], f))):
            _close(g.numpy()[m], np.asarray(w)[m], 1e-5, f"prestep {f}")
    _hold_tree(got["imp"], want["imp"], 1e-5, "carried impulses")
    _close(got["pcolor"], want["pcolor"], 0, "carried colors")
    assert (want["pcolor"] >= 0).sum() > 10  # colors carried from the cache
    _close(got["bodies"].awake, want["bodies"].awake, 0, "wake")

    bodies, imps, jimps, ovf, ccolors, jcolors, demand = got["solved"]
    wb, wimps, wj, wovf, wcc, wjc, wd = want["solved"]
    for f in ("pos", "orn", "vel", "omega"):
        _close_per_body(getattr(bodies, f), getattr(wb, f), 1e-5, f)
    _hold_tree(imps[0], wimps[0], 1e-5, "solved impulses")
    _close(ccolors[0], wcc[0], 0, "contact colors")
    assert sorted(jimps) == sorted(wj) == (["ball_socket"] if joint else [])
    for n in wj:
        _close(jimps[n], wj[n], 1e-5, n)
        _close(jcolors[n], wjc[n], 0, n)
    assert bool(ovf) == bool(wovf)
    _close(demand, wd, 0, "demand")
    assert np.abs(np.stack(wb.pos) - np.stack(before.bodies.pos)).max() > 1e-6

    _cache_fields(got["cache"], want["cache"], "cache")
    for f in ("key", "valid"):
        _close(getattr(got["bank"], f), getattr(want["bank"], f), 0, f"sleep bank {f}")
    assert bool(got["rovfl"]) == bool(want["rovfl"])


@pytest.mark.parametrize("joint,frame", [(False, FRAMES[0]), (False, FRAMES[1]),
                                         (True, FRAMES[0])],
                         ids=["pile-10", "pile-130", "ball_socket-10"])
def test_legacy_step_matches_jax_step(carried, frame, joint):
    run = carried[joint]
    before, want = run[frame]
    state, diag = tsim.step(state_from_numpy(before, "cpu"), shapes_from_numpy(run["shapes"], "cpu"),
                            joint_banks_from_numpy(run["banks"], "cpu"), DT,
                            _port_config(run["config"]), run["present"])
    got = state_to_numpy(state)
    assert got.store is None and want.store is None
    for f in ("pos", "orn", "vel", "omega"):
        _close_per_body(getattr(state.bodies, f), getattr(want.bodies, f), 1e-5, f)
    np.testing.assert_array_equal(got.bodies.awake, want.bodies.awake)
    np.testing.assert_array_equal(got.bodies.sleep_island, want.bodies.sleep_island)
    _cache_fields(got.cache, want.cache, "cache")
    for f in ("key", "valid"):
        np.testing.assert_array_equal(getattr(got.sleep_cache, f), getattr(want.sleep_cache, f))
    for n in want.joint_impulses:
        _close(got.joint_impulses[n], want.joint_impulses[n], 1e-5, n)
        _close(got.joint_colors[n], want.joint_colors[n], 0, n)
    assert not bool(diag.overflow)
    assert int(diag.pair_count) == int((want.cache.key != 2**31 - 1).sum())


def test_legacy_simulation_runs_and_reports():
    """Twelve port frames of the pile through ``Simulation``: finite, above the ground, no
    overflow, contacts reported from the cache, a checkpoint restoring the same bits, and
    ``reconfigure`` resizing the cache."""
    sim = legacy_pile(tbp)
    sim.run(12, DT)
    assert sim.state.store is None and sim.state.cache is not None
    sim._sync_from_device()
    pos = np.stack([sim._host.px, sim._host.py, sim._host.pz])
    assert np.isfinite(pos).all() and (pos[1][1:25] > -0.2).all()
    assert not bool(sim.last_diag.overflow)
    contacts = sim.contacts()
    assert len(contacts) > 10 and all(c["body_a"] < c["body_b"] for c in contacts)
    assert sim.live_contact_pairs() == {(c["body_a"], c["body_b"]) for c in contacts}
    data = sim.save_checkpoint()
    sim.run(3, DT)
    h = sim.state_hash()
    sim.load_checkpoint(data)
    sim.run(3, DT)
    assert sim.state_hash() == h
    sim.reconfigure(max_pairs=384)
    sim.run(1, DT)
    assert sim.state.cache.key.shape[0] == 384 and not bool(sim.last_diag.overflow)
