"""Slice 4 of the PyTorch port against the JAX package on the CPU: the general solve on the
windowed layout (joints beside the pair store, the store through kernel K4's plain
version), on the ragdoll pile (``models.build_ragdoll_pile_sim``: 4 ragdolls in two
layers of two, 2 substeps, 4 colors, grid2).

- ``solve_all`` from carried JAX states (frames 0-5, and frame 45, after the upper layer
  has landed), fed the same stage outputs in both packages, against the JAX ``solve_all``
  with ``backend="pallas_win"`` (its K4 in interpret mode): the same windows, slices and
  row math, so integers agree exactly and floats to 1e-5, absolute and relative. A body's
  position, orientation and velocities are held as vectors, relative to their length:
  limbs that collide at their joint anchors tumble at up to 44 rad/s in the first frames,
  and f32 op-order noise of a rotating vector lands in all its components. Component by
  component, a 1-ulp change of the input velocities alone moves frame 3's solve by up to
  0.77 of the 1e-5 limit, and the JAX package's own solve of one input by 0.39 between
  two XLA optimization levels; per body, the port stays within 0.63 of it (frames 0-5 and
  45, two jitter seeds).
- Ten frames of the pile through the port alone stay physical.

The JAX states are carried on its default path. The scene is built in the JAX package
from its public API here, at the positions the port's builder uses, and the port's
builder must give the same initial state. ``tests/test_torch_compound_pile.py`` holds the
contact-only compound branch the same way, with the helpers of this file.
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
from bepuphysics2_tpu.collision import pairstore as jstore
from bepuphysics2_tpu.models.ragdoll import add_ragdoll as jadd_ragdoll
from bepuphysics2_tpu.shapes import bounds as jbounds
from bepuphysics2_tpu.sleep import wake_touched as jwake
from bepuphysics2_tpu.solver import solve as jsolve
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

import bepuphysics2_tpu_torch.integrator as tintegrator
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.interop import _to_torch, joint_banks_from_numpy, state_from_numpy
from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim
from bepuphysics2_tpu_torch.models.scenes import ragdoll_pile_config, ragdoll_pile_positions
from bepuphysics2_tpu_torch.solver.solve import solve_all

DT = 1 / 60
N_RAG, LAYER = 4, (2, 1)
PILE_FRAMES = (0, 1, 2, 3, 4, 5, 45)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_ragdoll_pile():
    """The port's ``build_ragdoll_pile_sim(4, substeps=2, num_colors=4, layer=(2, 1),
    broadphase="grid2")`` in the JAX package."""
    sim = jbp.Simulation(jbp.SimConfig(**ragdoll_pile_config(N_RAG, 2, 4), broadphase="grid2"))
    ground = sim.add_shape(jbp.Box(100.0, 0.5, 100.0))
    sim.add_static(jbp.StaticDescription(position=(0.0, -0.5, 0.0), shape=ground))
    for p in ragdoll_pile_positions(N_RAG, LAYER, 0):
        jadd_ragdoll(sim, position=tuple(float(c) for c in p))
    return sim


def _carry(sim, frames):
    """Config, present types, shapes, joint banks and the state after each frame count."""
    out = dict(config=sim.config,
               present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})),
               states={0: _np(sim.state)})
    for frame in range(1, max(frames) + 1):
        sim.timestep(DT)
        if frame in frames:
            out["states"][frame] = _np(sim.state)
    out["shapes"] = _np(sim.shapes.device())
    out["banks"] = _np({name: {k: v for k, v in store.device().items() if k != "impulse"}
                        for name, store in sim.joints.items() if store.count > 0})
    return out


@pytest.fixture(scope="module")
def jax_pile():
    return _carry(_jax_ragdoll_pile(), PILE_FRAMES)


def _jax_stages(state, shapes, banks, config, present, compound):
    """The JAX store path of ``_step_impl`` up to the solve (grid2 above the brute-force
    range of the config), with the compound bank when ``compound``."""
    b = state.bodies
    dt = jnp.float32(DT)
    lo, hi = jbounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, dt,
                                         spec_min=b.spec_margin_min)
    has, big = b.shape >= 0, jnp.float32(3.0e38)
    lo = lo.where(has, JVec3.full(has.shape, big, big, big))
    hi = hi.where(has, JVec3.full(has.shape, -big, -big, -big))
    if config.broadphase == "grid2":
        pairs = jbroad.grid2(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs,
                             config.grid_cell_size, config.grid_cell_capacity,
                             config.grid_max_large, config.grid_entry_factor,
                             config.grid_cell_factor, config.grid_pair_k)
    else:
        pairs = jbroad.brute_force(lo, hi, b.kind, b.awake, b.collision_group,
                                   config.max_pairs)
    sa = jnp.maximum(b.shape[pairs.a], 0)
    sb = jnp.maximum(b.shape[pairs.b], 0)
    ins = (shapes.type[sa] <= 5) & (shapes.type[sb] <= 5)
    ext = jnp.zeros(config.body_capacity + 1, jnp.int32)
    for name in banks:
        ext = ext | jstore.store_claims(banks[name]["bodies"], state.joint_colors[name],
                                        banks[name]["valid"], config.body_capacity,
                                        config.num_colors)
    cc = state.ccache
    ext = ext | jstore.store_claims(jnp.stack([cc.body_a, cc.body_b], -1), cc.color, cc.valid,
                                    config.body_capacity, config.num_colors)
    churn, dead, repair = config.store_caps()
    store, _, _, active = jstore.update(
        state.store, b.kind, b.awake, b.collision_group, lo, hi, pairs.a, pairs.b,
        pairs.valid, ins, config.num_colors, ext, churn, dead, repair)
    ps, imp, _ = jnarrow.narrow_phase_store(b, shapes, store, active, dt, present_types=present)
    b = jwake(b, ps)
    out = dict(bodies=b, store=store, active=active, ps=ps, imp=imp)
    if compound:
        cps, cimp, ccol, _, _ = jnarrow.narrow_phase_compound(
            b, shapes, pairs, state.ccache, dt, config.max_compound_pairs,
            config.children_per_pair, config.child_window, present_types=present,
            sleep_bank=state.sleep_ccache)
        out.update(bodies=jwake(b, cps), cps=cps, cimp=cimp, ccol=ccol)
    return out


def _jax_solve(st, banks, state, config, backend):
    jbanks = {n: dict(banks[n], impulse=state.joint_impulses[n], color=state.joint_colors[n])
              for n in banks}
    cbanks = [(st["cps"], st["cimp"], st["ccol"])] if "cps" in st else []
    return jsolve.solve_all(
        st["bodies"], cbanks, jbanks, config.integrator,
        dataclasses.replace(config.solve_config(), backend=backend), jnp.float32(DT),
        store_bank=dict(store=st["store"], ps=st["ps"], imp=st["imp"], active=st["active"]),
        base_used=st["store"].used)


_STAGES = jax.jit(_jax_stages, static_argnums=(3, 4, 5))
_SOLVE = jax.jit(_jax_solve, static_argnums=(3, 4))


def _close(got, want, tol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _solve_both(carried_run, frame, backend, compound):
    """One solve from the carried JAX state of ``frame`` in both packages. Returns
    (port outputs, JAX outputs, stage outputs, carried state)."""
    cfg, present = carried_run["config"], carried_run["present"]
    carried = carried_run["states"][frame]
    state = jax.tree_util.tree_map(jnp.asarray, carried)
    banks = jax.tree_util.tree_map(jnp.asarray, carried_run["banks"])
    st = _np(_STAGES(state, jax.tree_util.tree_map(jnp.asarray, carried_run["shapes"]), banks,
                     cfg, present, compound))
    want = _np(_SOLVE(jax.tree_util.tree_map(jnp.asarray, st), banks, state, cfg, backend))

    t = lambda x: _to_torch(x, "cpu")
    tcfg = tsim.SimConfig(**dict(vars(cfg), integrator=tintegrator.IntegratorConfig(
        **vars(cfg.integrator))))
    tstate = state_from_numpy(carried, "cpu")
    tbanks = {n: dict(joint_banks_from_numpy(carried_run["banks"], "cpu")[n],
                      impulse=tstate.joint_impulses[n], color=tstate.joint_colors[n])
              for n in carried_run["banks"]}
    cbanks = [(t(st["cps"]), t(st["cimp"]), t(st["ccol"]))] if compound else []
    got = solve_all(
        t(st["bodies"]), cbanks, tbanks, tcfg.integrator,
        dataclasses.replace(tcfg.solve_config(), backend=backend), float(np.float32(DT)),
        store_bank=dict(store=t(st["store"]), ps=t(st["ps"]), imp=t(st["imp"]),
                        active=t(st["active"])),
        base_used=t(st["store"].used))
    return got, want, st, carried


def _close_per_body(got, want, tol, what):
    """Each body's vector (position, orientation, velocity or angular velocity) within
    ``tol`` of the reference's, absolute and relative to the vector's own length."""
    g = np.stack([x.numpy() for x in got])
    w = np.stack([np.asarray(x) for x in want])
    err = np.linalg.norm(g - w, axis=0)
    lim = tol + tol * np.linalg.norm(w, axis=0)
    assert (err <= lim).all(), f"{what}: worst {(err / lim).max():.3f} of the limit"


def _hold(got, want, carried, joint_names):
    bodies, imps, jimps, ovf, ccolors, jcolors, demand = got
    wb, wimps, wj, wovf, wcc, wjc, wd = want
    for f in ("pos", "orn", "vel", "omega"):
        _close_per_body(getattr(bodies, f), getattr(wb, f), 1e-5, f)
    assert len(imps) == len(wimps)
    for gi, wi in zip(imps, wimps):
        for g, w in zip(jax.tree_util.tree_leaves(tuple(gi)), jax.tree_util.tree_leaves(wi)):
            _close(g, w, 1e-5, "contact impulses")
    assert sorted(jimps) == sorted(wj) == joint_names
    for n in wj:
        _close(jimps[n], wj[n], 1e-5, n)
        _close(jcolors[n], wjc[n], 0, n)
    for g, w in zip(ccolors, wcc):
        _close(g, w, 0, "contact colors")
    assert bool(ovf) == bool(wovf)
    _close(demand, wd, 0, "demand")
    assert np.abs(np.stack(wb.pos) - np.stack(carried.bodies.pos)).max() > 1e-4


@pytest.mark.parametrize("frame", PILE_FRAMES)
def test_windowed_general_solve_matches_jax_pallas_win(jax_pile, frame):
    """Every output of one windowed general solve, from identical stage outputs: bodies,
    the store's slot-order impulses, joint impulses and colors (exact), overflow and
    demand; K4 is the plain version's, and the store has live rows."""
    got, want, st, carried = _solve_both(jax_pile, frame, "pallas_win", False)
    assert int(st["ps"].valid.sum()) > 0
    _hold(got, want, carried, ["ball_socket", "swing_limit"])
    assert np.abs(np.asarray(want[2]["ball_socket"])).max() > 1e-4


def _positions(sim):
    sim._sync_from_device()
    return np.stack([sim._host.px, sim._host.py, sim._host.pz])


def test_ragdoll_pile_builder_and_frames_stay_physical(jax_pile):
    """The port's builder gives the JAX scene's state; ten port frames on the windowed
    general path (K4's plain version) stay finite, above the ground, every ragdoll whole,
    with no overflow."""
    sim, cfg = build_ragdoll_pile_sim(N_RAG, substeps=2, num_colors=4, layer=LAYER,
                                      device="cpu", solver_backend="pallas_win",
                                      broadphase="grid2")
    want = jax_pile["states"][0].bodies
    for f in ("pos", "orn", "inv_mass", "kind"):
        _close(torch.stack(list(getattr(sim.state.bodies, f))) if f in ("pos", "orn")
               else getattr(sim.state.bodies, f), np.stack(getattr(want, f))
               if f in ("pos", "orn") else getattr(want, f), 0, f)
    assert dataclasses.replace(cfg, solver_backend="auto") == dataclasses.replace(
        tsim.SimConfig(**{**vars(jax_pile["config"]), "integrator": cfg.integrator}),
        solver_backend="auto")
    ovf = False
    for _ in range(10):
        sim.timestep(DT)
        ovf = ovf or bool(sim.last_diag.overflow)
    got = _positions(sim)
    dyn = sim._host.kind == 1
    assert np.isfinite(got).all() and not ovf and int(sim.last_diag.contact_count) > 0
    assert (got[1][dyn] > -0.2).all()
    for k in range(N_RAG):  # torso 1 + 10k, head 2 + 10k
        assert np.linalg.norm(got[:, 2 + 10 * k] - got[:, 1 + 10 * k]) < 1.2


def test_windowed_store_needs_whole_slices():
    """The windowed layout runs slices of 256 rows: a pair store whose capacity is not a
    multiple of 256 (here 1,408 rows in pages of 128) is refused with the reason, not
    left to fail in a reshape."""
    sim, _ = build_ragdoll_pile_sim(1, substeps=2, num_colors=4, device="cpu",
                                    solver_backend="pallas_win", max_pairs=1408)
    with pytest.raises(ValueError, match="multiple of 256"):
        sim.timestep(DT)
