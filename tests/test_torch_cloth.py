"""Queue 1 item 22's cloth through the port against the JAX package on the CPU: a 6 x 6
lattice (36 nodes, 110 ``center_distance`` links) dropped over a static sphere on a static
ground (``models.build_cloth_sim``; the JAX scene through its own ``add_cloth``,
``tools/reference_cloth.py``). ``max_pairs`` 4,096 (a store page of 128), so the JAX
package takes its Pallas layout with ``backend="pallas"`` (its K3 in interpret mode).

- One port step from each carried JAX state (every other of the first 12 frames: the
  lattice, dropped 0.1 m, lands on the sphere, its nodes' contacts beside the unified
  joint bank) against the JAX package's next state: bodies, link impulses and
  the store's impulses within 1e-5, link colors exact.
- The builders agree: the same nodes, links and prestep.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

from bepuphysics2_tpu_torch.interop import (
    joint_banks_from_numpy, shapes_from_numpy, state_from_numpy, state_to_numpy,
)
from bepuphysics2_tpu_torch.models import build_cloth_sim
import bepuphysics2_tpu_torch.simulation as tsim

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.reference_cloth import jax_cloth_sim  # noqa: E402

DT = 1 / 60
WIDTH = 6
FRAMES = 12
HELD = tuple(range(0, FRAMES, 2))
CFG = dict(solver_backend="pallas", drop=0.1, substeps=4)  # 4 substeps: half the JAX time


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


@pytest.fixture(scope="module")
def carried():
    sim, _, grid = jax_cloth_sim(WIDTH, WIDTH, **CFG)
    states = [_np(sim.state)]
    contacts = []
    for _ in range(FRAMES):
        sim.timestep(DT)
        states.append(_np(sim.state))
        contacts.append(int(sim.last_diag.contact_count))
    banks = {n: {k: np.asarray(v) for k, v in st.device().items() if k != "impulse"}
             for n, st in sim.joints.items() if st.count > 0}
    return dict(states=states, banks=banks, contacts=contacts, grid=grid,
                shapes=_np(sim.shapes.device()),
                present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5,
                               err_msg=what)


def test_builders_agree(carried):
    sim, config, grid = build_cloth_sim(WIDTH, WIDTH, device="cpu", **CFG)
    np.testing.assert_array_equal(grid, carried["grid"])
    st = sim.joints["center_distance"]
    assert st.count == 110 == carried["banks"]["center_distance"]["valid"].sum()
    for f in ("bodies", "valid", "prestep"):
        np.testing.assert_array_equal(st.device("cpu")[f].numpy(),
                                      carried["banks"]["center_distance"][f], err_msg=f)
    got, want = state_to_numpy(sim.state).bodies, carried["states"][0].bodies
    for f in ("pos", "orn", "inv_inertia"):
        for g, w in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("inv_mass", "kind", "shape", "collision_group", "sleep_threshold"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("frame", HELD)
def test_cloth_step_matches_jax_pallas(carried, frame):
    before, want = carried["states"][frame], carried["states"][frame + 1]
    cfg = build_cloth_sim(WIDTH, WIDTH, device="cpu", **CFG)[1]
    state, diag = tsim.step(state_from_numpy(before, "cpu"),
                            shapes_from_numpy(carried["shapes"], "cpu"),
                            joint_banks_from_numpy(carried["banks"], "cpu"), DT, cfg,
                            carried["present"])
    got = state_to_numpy(state)
    for f in ("pos", "orn", "vel", "omega"):
        for g, w in zip(getattr(got.bodies, f), getattr(want.bodies, f)):
            _close(g, w, f)
    _close(got.joint_impulses["center_distance"], want.joint_impulses["center_distance"],
           "link impulses")
    np.testing.assert_array_equal(got.joint_colors["center_distance"],
                                  want.joint_colors["center_distance"])
    for f in ("imp_pen", "imp_tx", "imp_ty", "imp_tw"):
        _close(getattr(got.store, f), getattr(want.store, f), f)
    assert int(diag.contact_count) == carried["contacts"][frame]
    assert not bool(diag.overflow)


def test_the_lattice_reaches_the_sphere(carried):
    """Every held frame solves the nodes' contacts with the sphere beside the links."""
    assert min(carried["contacts"][f] for f in HELD) > 0


# --- add_cloth's own settings: the store's churn (ROADMAP queue 3) ----------------------

def _store_admission(package, state, shapes, config):
    """Bounds, brute-force broad phase and one pair-store update (the step's store stage)
    in ``package`` ("jax" or "port") from ``state``: (overflow, demand (3,), live rows)."""
    churn, dead, repair = config.store_caps()
    if package == "jax":
        import jax.numpy as jnp
        from bepuphysics2_tpu.collision import broadphase as jbroad, pairstore as jstore
        from bepuphysics2_tpu.shapes import bounds as jbounds

        @jax.jit
        def run(state, shapes):
            b = state.bodies
            lo, hi = jbounds.compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape, shapes,
                                                 jnp.float32(DT), spec_min=b.spec_margin_min)
            pairs = jbroad.brute_force(lo, hi, b.kind, b.awake, b.collision_group,
                                       config.max_pairs)
            store, ovf, demand, _ = jstore.update(
                state.store, b.kind, b.awake, b.collision_group, lo, hi, pairs.a, pairs.b,
                pairs.valid, jnp.ones_like(pairs.valid), config.num_colors,
                jnp.zeros(config.body_capacity + 1, jnp.int32), churn, dead, repair)
            return ovf, demand, store.live

        out = run(jax.tree_util.tree_map(jnp.asarray, state),
                  jax.tree_util.tree_map(jnp.asarray, shapes))
        return tuple(np.asarray(x) for x in out)
    from bepuphysics2_tpu_torch.collision import broadphase, pairstore
    from bepuphysics2_tpu_torch.shapes import compute_body_bounds

    st = state_from_numpy(state, "cpu")
    b = st.bodies
    lo, hi = compute_body_bounds(b.pos, b.orn, b.vel, b.omega, b.shape,
                                 shapes_from_numpy(shapes, "cpu"), float(np.float32(DT)),
                                 spec_min=b.spec_margin_min)
    pairs = broadphase.brute_force(lo, hi, b.kind, b.awake, b.collision_group,
                                   config.max_pairs)
    store, ovf, demand, _ = pairstore.update(
        st.store, b.kind, b.awake, b.collision_group, lo, hi, pairs.a, pairs.b, pairs.valid,
        torch.ones_like(pairs.valid), config.num_colors,
        torch.zeros(config.body_capacity + 1, dtype=torch.int32), churn, dead, repair)
    return ovf.numpy(), demand.numpy(), store.live.numpy()


@pytest.mark.parametrize("width", [22, 24])
def test_own_settings_store_churn_matches_jax(width):
    """``add_cloth``'s own settings (``tools/cloth_own_settings.py``: 25 Hz links,
    spinning nodes, the default ``store_churn`` of 512 for ``max_pairs`` 4,096), the
    lattice laid flat on the ground, so that every node meets the ground in one step:
    22 x 22 nodes (484 admissions) fit the churn, 24 x 24 (576) spill it and set the
    store's overflow bit (4) in both packages, which admit the same rows. Stepped whole
    (the tool, both packages, 45 steps each), a dropped 32 x 32 lattice is the smallest
    that sets the bit: at step 41 both admit 524 pairs against the churn of 512 and give
    the same bits, admissions and live rows on every step; 24 x 24 and 28 x 28 peak
    below the churn."""
    from tools.cloth_own_settings import own_cloth_sim

    states = []
    for package in ("jax", "port"):
        sim, grid = own_cloth_sim(package, width, drop=0.0)
        sim._sync_from_device()
        h = sim._host
        nodes = grid.reshape(-1)
        h.px[nodes] += (width - 1) * 0.25 / 2 + 0.125 * width * 0.25 + 0.5  # beside the sphere
        h.py[nodes] = 0.25 * 0.3 - 0.01  # a node's radius, resting 1 cm into the ground
        sim._dirty = True
        states.append((sim, state_to_numpy(sim.state) if package == "port"
                       else _np(sim.state)))
    (jsim, jstate), (tsim_, _) = states
    shapes, config = _np(jsim.shapes.device()), jsim.config
    want = _store_admission("jax", jstate, shapes, config)
    got = _store_admission("port", jstate, shapes, tsim_.config)
    assert bool(got[0]) == bool(want[0]) == (width * width > config.store_caps()[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert int(want[1][0]) == width * width  # one ground pair a node asks to be admitted
