"""The port's general solve path (joints and a compound bank beside the pair store, kernel
K3's plain version) against the JAX package on the 2-ragdoll tube of
``tests/test_models.py``'s ``test_ragdoll_tube_scenario`` (``max_pairs`` 1,024, so the
store's page is 128 and the JAX package can take its Pallas layout).

- ``solve_all`` from carried JAX states (each of the first ten frames, and frame 60, when
  the ragdolls lie on the tube's panels), fed the same stage outputs in both packages,
  against the JAX ``solve_all`` with ``backend="pallas"`` (its K3 in interpret mode): the
  same coloring, buckets, slices and row math, so integers agree exactly and floats to
  1e-5, absolute and relative (f32 op-order noise scales with the value: limbs tumbling
  on the spinning panels reach 34 rad/s).
- The port's own ten-frame trajectory: within 1e-5 of the JAX package's for two frames,
  then physical (finite, inside the tube, every ragdoll whole).

Trajectories are not held to the pile's 20-frame envelope (5e-3 max, 1e-4 median): the
ragdoll's jointed limbs also collide (the model sets no collision groups), and where two
capsule axes cross at a joint anchor the contact normal is the direction of a vector of
~1e-8, rounding noise that differs between XLA's and PyTorch's CPU kernels. One such
contact turns a 5e-7 difference into 5e-2 in one frame (frame 3 here); the JAX
package's own XLA and Pallas paths, which share their tester code, agree to 5e-7 per step
and still drift apart by 0.37 in ten frames.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu.collision import broadphase as jbroad
from bepuphysics2_tpu.collision import narrowphase as jnarrow
from bepuphysics2_tpu.collision import pairstore as jstore
from bepuphysics2_tpu.shapes import bounds as jbounds
from bepuphysics2_tpu.sleep import wake_touched as jwake
from bepuphysics2_tpu.solver import solve as jsolve
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

import bepuphysics2_tpu_torch.integrator as tintegrator
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.interop import _to_torch, joint_banks_from_numpy, state_from_numpy
from bepuphysics2_tpu_torch.models import build_ragdoll_tube_sim
from bepuphysics2_tpu_torch.solver.solve import solve_all

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _build_ragdoll_tube_sim  # noqa: E402

DT = 1 / 60
FRAMES = 10
CARRIED = 60  # the ragdolls lie on the tube's panels: every bank has live rows
# Frames stepped before the solve compared. One module holds them all, so the JAX tube's
# step, its stages and its Pallas solve compile once.
SOLVED = tuple(range(FRAMES)) + (CARRIED,)


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


def _positions(sim):
    sim._sync_from_device()
    return np.stack([sim._host.px, sim._host.py, sim._host.pz])


def _banks(sim):
    return {name: {k: v for k, v in store.device().items() if k != "impulse"}
            for name, store in sim.joints.items() if store.count > 0}


def carry_jax_tube(frames):
    """The JAX tube stepped on its default path: config, present types, shapes, joint
    banks, the state after each frame count in ``frames``, and the positions at frame 2."""
    sim, _ = _build_ragdoll_tube_sim(2, substeps=2, num_colors=4)
    out = dict(config=sim.config,
               present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})),
               states={0: _np(sim.state)})
    for frame in range(1, max(max(frames), 2) + 1):
        sim.timestep(DT)
        if frame in frames:
            out["states"][frame] = _np(sim.state)
        if frame == 2:
            out["p2"] = _positions(sim)
    out["shapes"] = _np(sim.shapes.device())
    out["banks"] = _np(_banks(sim))
    return out


@pytest.fixture(scope="module")
def jax_tube():
    return carry_jax_tube(SOLVED)


def _jax_stages(state, shapes, banks, config, present):
    """The JAX store path of ``_step_impl`` up to the solve, with the compound bank."""
    b = state.bodies
    dt = jnp.float32(DT)
    lo, hi = jbounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes, dt,
                                         spec_min=b.spec_margin_min)
    has, big = b.shape >= 0, jnp.float32(3.0e38)
    lo = lo.where(has, JVec3.full(has.shape, big, big, big))
    hi = hi.where(has, JVec3.full(has.shape, -big, -big, -big))
    pairs = jbroad.brute_force(lo, hi, b.kind, b.awake, b.collision_group, config.max_pairs)
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
    cps, cimp, ccol, _, _ = jnarrow.narrow_phase_compound(
        b, shapes, pairs, state.ccache, dt, config.max_compound_pairs,
        config.children_per_pair, config.child_window, present_types=present,
        sleep_bank=state.sleep_ccache)
    b = jwake(jwake(b, ps), cps)
    return dict(bodies=b, store=store, active=active, ps=ps, imp=imp, cps=cps, cimp=cimp,
                ccol=ccol)


def _jax_solve(st, banks, state, config):
    jbanks = {n: dict(banks[n], impulse=state.joint_impulses[n], color=state.joint_colors[n])
              for n in banks}
    return jsolve.solve_all(
        st["bodies"], [(st["cps"], st["cimp"], st["ccol"])], jbanks, config.integrator,
        dataclasses.replace(config.solve_config(), backend="pallas"), jnp.float32(DT),
        store_bank=dict(store=st["store"], ps=st["ps"], imp=st["imp"], active=st["active"]),
        base_used=st["store"].used)


def _port_config(cfg):
    return tsim.SimConfig(**dict(vars(cfg), integrator=tintegrator.IntegratorConfig(
        **vars(cfg.integrator))))


def _close(got, want, tol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


_STAGES = jax.jit(_jax_stages, static_argnums=(3, 4))
_SOLVE = jax.jit(_jax_solve, static_argnums=(3,))


@pytest.mark.parametrize("frame", SOLVED)
def test_general_solve_matches_jax_pallas(jax_tube, frame):
    check_general_solve(jax_tube, frame)


def check_general_solve(jax_tube, frame):
    """Every output of one general solve, from identical stage outputs: bodies, both contact
    banks' impulses, joint impulses, overflow, persisted colors (exact) and demand."""
    cfg, present = jax_tube["config"], jax_tube["present"]
    carried = jax_tube["states"][frame]
    state = jax.tree_util.tree_map(jnp.asarray, carried)
    banks = jax.tree_util.tree_map(jnp.asarray, jax_tube["banks"])
    st = _np(_STAGES(state, jax.tree_util.tree_map(jnp.asarray, jax_tube["shapes"]), banks, cfg,
                     present))
    assert int(st["ps"].valid.sum()) > 0
    want = _np(_SOLVE(jax.tree_util.tree_map(jnp.asarray, st), banks, state, cfg))

    t = lambda x: _to_torch(x, "cpu")
    tcfg = _port_config(cfg)
    tstate = state_from_numpy(carried, "cpu")
    tbanks = {n: dict(joint_banks_from_numpy(jax_tube["banks"], "cpu")[n],
                      impulse=tstate.joint_impulses[n], color=tstate.joint_colors[n])
              for n in jax_tube["banks"]}
    got = solve_all(
        t(st["bodies"]), [(t(st["cps"]), t(st["cimp"]), t(st["ccol"]))], tbanks,
        tcfg.integrator, tcfg.solve_config(), float(np.float32(DT)),
        store_bank=dict(store=t(st["store"]), ps=t(st["ps"]), imp=t(st["imp"]),
                        active=t(st["active"])),
        base_used=t(st["store"].used))
    bodies, imps, jimps, ovf, ccolors, jcolors, demand = got
    wb, wimps, wj, wovf, wcc, wjc, wd = want
    for f in ("pos", "orn", "vel", "omega"):
        for g, w in zip(getattr(bodies, f), getattr(wb, f)):
            _close(g, w, 1e-5, f)
    for gi, wi in zip(imps, wimps):
        for g, w in zip(jax.tree_util.tree_leaves(tuple(gi)), jax.tree_util.tree_leaves(wi)):
            _close(g, w, 1e-5, "contact impulses")
    assert sorted(jimps) == sorted(wj) == ["ball_socket", "swing_limit"]
    for n in wj:
        _close(jimps[n], wj[n], 1e-5, n)
        _close(jcolors[n], wjc[n], 0, n)
    _close(ccolors[0], wcc[0], 0, "compound colors")
    assert bool(ovf) == bool(wovf)
    _close(demand, wd, 0, "demand")
    moved = np.abs(np.stack(wb.pos) - np.stack(carried.bodies.pos)).max()
    assert moved > 1e-4 and np.abs(np.asarray(wj["ball_socket"])).max() > 1e-4
    if frame == CARRIED:
        assert int(st["cps"].valid.sum()) > 0  # the compound bank solves live rows


def test_ten_frames_of_the_tube_stay_physical(jax_tube):
    sim, _ = build_ragdoll_tube_sim(2, substeps=2, num_colors=4, device="cpu")
    ovf = False
    for frame in range(1, FRAMES + 1):
        sim.timestep(DT)
        ovf = ovf or bool(sim.last_diag.overflow)
        if frame == 2:
            np.testing.assert_allclose(_positions(sim), jax_tube["p2"], rtol=0, atol=1e-5)
    got = _positions(sim)
    assert np.isfinite(got).all() and not ovf and int(sim.last_diag.contact_count) > 0
    dyn = sim._host.kind == 1
    assert (got[1][dyn] > 0.0).all()
    assert (np.hypot(got[0][dyn], got[1][dyn] - 6.0) < 4.5).all()  # inside the tube
    for k in range(2):  # torso 1 + 10k, head 2 + 10k
        assert np.linalg.norm(got[:, 2 + 10 * k] - got[:, 1 + 10 * k]) < 1.2
