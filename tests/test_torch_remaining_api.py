"""The JAX package's last public functions in the PyTorch port, against the JAX package on
the CPU (``solve_contacts`` is held in ``tests/test_torch_legacy.py``, on that file's
carried pile):

- ``simulation.step_n``: eight steps in one call bit for bit equal to eight single
  ``step`` calls of the port, with ``overflow`` and ``overflow_src`` sticky over them and
  ``demand`` their peak (``tests/test_simulation.py``'s ``test_scanned_run_matches_per_step``
  holds the JAX one so; no JAX step is compiled here);
- ``BodyState.empty`` and ``shapes.registry.inertia_from_diag``: leaf for leaf equal;
- ``solver.coloring.color_constraints``, ``color_constraints_kary`` (with and without
  ``segments``) and ``jacobi_valence`` on seeded random constraint tables: exactly equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu import bodies as jbodies
from bepuphysics2_tpu.shapes import registry as jreg
from bepuphysics2_tpu.solver import coloring as jcol

import bepuphysics2_tpu_torch as tbp
from bepuphysics2_tpu_torch import bodies as tbodies
from bepuphysics2_tpu_torch import simulation as tsim
from bepuphysics2_tpu_torch.shapes import registry as treg
from bepuphysics2_tpu_torch.solver import coloring as tcol

DT = 1 / 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    return list(tsim._leaves(tree))


def _pile(max_pairs):
    """``test_scanned_run_matches_per_step``'s scene: four spheres stacked on a box."""
    sim = tbp.Simulation(tbp.SimConfig(body_capacity=16, max_pairs=max_pairs, substeps=2,
                                       velocity_iterations=1), device="cpu")
    ground = sim.add_shape(tbp.Box(10.0, 0.5, 10.0))
    s = tbp.Sphere(0.4)
    shape = sim.add_shape(s)
    sim.add_static(tbp.StaticDescription(position=(0, -0.5, 0), shape=ground))
    for i in range(4):
        sim.add_body(tbp.BodyDescription.dynamic((0.1 * i, 1.0 + 0.9 * i, 0), shape, 1.0, s))
    sim.run(1, DT)
    return sim, (sim.shapes.device("cpu"), sim._joint_banks("cpu"), DT, sim.config,
                 sim._present_types())


@pytest.mark.parametrize("max_pairs", [64, 2], ids=["fits", "overflows"])
def test_step_n_matches_single_steps(max_pairs):
    sim, scene = _pile(max_pairs)
    state0 = sim.state
    got, diag = tsim.step_n(state0, *scene, 8)
    state, overflow, src, peak = state0, False, 0, None
    for _ in range(8):
        state, d = tsim.step(state, *scene)
        overflow, src = overflow | bool(d.overflow), src | int(d.overflow_src)
        peak = d.demand if peak is None else torch.maximum(peak, d.demand)
    got_leaves, want_leaves = _leaves(got), _leaves(state)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert torch.equal(g, w)
    assert bool(diag.overflow) == overflow and int(diag.overflow_src) == src
    assert torch.equal(diag.demand, peak)
    assert overflow == (max_pairs == 2)
    assert float((got.bodies.pos.y - state0.bodies.pos.y).abs().max()) > 1e-3  # it moved


def test_body_state_empty_matches_jax():
    want = jax.tree_util.tree_leaves(jbodies.BodyState.empty(7))
    got = _leaves(tbodies.BodyState.empty(7, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_inertia_from_diag_matches_jax():
    diag = np.float32([0.5, 2.0, 1.25])
    jm, jsym = jreg.inertia_from_diag(np.float32(0.25), jnp.asarray(diag))
    tm, tsym = treg.inertia_from_diag(0.25, torch.from_numpy(diag))
    assert float(tm) == float(jm)
    for g, w in zip(tsym, jsym):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _table(seed, m=96, k=2, n_bodies=24):
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, n_bodies, (m, k)).astype(np.int32)
    dyn = rng.uniform(size=(m, k)) > 0.15
    valid = rng.uniform(size=m) > 0.1
    return refs, dyn, valid, n_bodies


@pytest.mark.parametrize("seed", [0, 1])
def test_color_constraints_match_jax(seed):
    refs, dyn, valid, n_bodies = _table(seed)
    t = torch.from_numpy
    want = np.asarray(jcol.color_constraints(refs[:, 0], refs[:, 1], dyn[:, 0], dyn[:, 1],
                                             valid, n_bodies, 4))
    got = tcol.color_constraints(t(refs[:, 0]), t(refs[:, 1]), t(dyn[:, 0]), t(dyn[:, 1]),
                                 t(valid), n_bodies, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 4).sum() > 10 and (want[valid] == 4).any()  # colored rows and a bucket
    in_jacobi = valid & (want == 4)
    want_v = np.asarray(jcol.jacobi_valence(refs[:, 0], refs[:, 1], dyn[:, 0], dyn[:, 1],
                                            in_jacobi, n_bodies))
    got_v = tcol.jacobi_valence(t(refs[:, 0]), t(refs[:, 1]), t(dyn[:, 0]), t(dyn[:, 1]),
                                t(in_jacobi), n_bodies)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_v.max() > 1


@pytest.mark.parametrize("segments", [None, ((0, 40, 6), (40, 56, 5))],
                         ids=["whole", "segments"])
def test_color_constraints_kary_matches_jax(segments):
    refs, dyn, valid, n_bodies = _table(2, k=3)
    want_c, want_r = (np.asarray(x) for x in jcol.color_constraints_kary(
        refs, dyn, valid, n_bodies, 5, segments=None if segments is None else list(segments)))
    got_c, got_r = tcol.color_constraints_kary(torch.from_numpy(refs), torch.from_numpy(dyn),
                                               torch.from_numpy(valid), n_bodies, 5,
                                               segments=segments)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    if segments is not None:
        assert (want_r >= 0).any() and (want_r == 5).sum() == 0
