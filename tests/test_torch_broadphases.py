"""The ``sweep`` and ``grid`` broad phases of the PyTorch port against the JAX package on
the CPU.

- On random AABB sets (empty slots, kinematic and sleeping bodies, collision groups, large
  bodies, and bodies exactly 1,024 cells apart, which alias in the grid's wrapped keys and
  must fail the exact test), each function's pair list, validity, overflow flag and demand
  counters equal the JAX function's, at capacities that hold every pair and at ones that
  overflow (``max_pairs``, the sweep's window, the grid's cell capacity).
- Three steps of the 24-body pile (``tests/test_torch_sim.py``, on the pair store) with
  each broad phase: every step's pair list, taken inside the step, equal to the JAX
  function's on the same bounds (the store admits pairs in list order, so the order is
  held too; the rest of the step is the store path, held to the JAX step in
  ``test_torch_sim.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bepuphysics2_tpu.collision import broadphase as jbroad
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.collision import broadphase
from bepuphysics2_tpu_torch.utils.vec import Vec3

from test_torch_sim import _pile

DT = 1 / 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _aabbs(seed, n=96):
    """Random bounds, kinds, awake flags and groups; bodies 0-2 are large slabs, body 5 sits
    1,536 m (1,024 cells of 1.5 m) from body 4 along x."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.3, 1.4, (n, 3)).astype(np.float32)
    lo[:3], hi[:3] = lo[:3] - [[8.0, 0.2, 8.0]], hi[:3] + [[8.0, 0.2, 8.0]]
    lo[5], hi[5] = lo[4] + [1536.0, 0, 0], hi[4] + [1536.0, 0, 0]
    kind = rng.choice([0, 1, 1, 1, 1, 2], n).astype(np.int32)
    kind[:3], kind[4], kind[5] = 2, 1, 1
    awake = rng.uniform(size=n) < 0.85
    group = rng.choice([0, 0, 0, 0, 1, 2], n).astype(np.int32)
    return lo, hi, kind, awake, group


_J = {
    "sweep": jax.jit(jbroad.sweep, static_argnums=(5, 6)),
    "grid": jax.jit(jbroad.grid, static_argnums=(5, 6, 7, 8)),
}


def _both(name, seed, *static):
    lo, hi, kind, awake, group = _aabbs(seed)
    want = _J[name](JVec3(*map(jnp.asarray, lo.T)), JVec3(*map(jnp.asarray, hi.T)),
                    jnp.asarray(kind), jnp.asarray(awake), jnp.asarray(group), *static)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = getattr(broadphase, name)(Vec3(*map(t, lo.T)), Vec3(*map(t, hi.T)), t(kind),
                                    t(awake), t(group), *static)
    return got, jax.tree_util.tree_map(np.asarray, want)


def _same(got, want):
    for f in ("a", "b", "valid", "overflow", "demand"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("static", [(512, 64), (512, 4), (24, 64)],
                         ids=["roomy", "narrow_window", "few_pairs"])
def test_sweep_matches_jax(seed, static):
    got, want = _both("sweep", seed, *static)
    _same(got, want)
    assert int(want.valid.sum()) >= (20 if static == (512, 64) else 5)
    if static != (512, 64):
        assert bool(want.overflow)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("static", [(512, 0.0, 16, 64), (512, 1.5, 16, 64), (512, 1.5, 2, 64),
                                    (24, 0.0, 16, 64)],
                         ids=["adaptive", "fixed_cells", "small_cells", "few_pairs"])
def test_grid_matches_jax(seed, static):
    got, want = _both("grid", seed, *static)
    _same(got, want)
    assert int(want.demand[2]) >= 3  # the large slabs
    assert int(want.valid.sum()) >= min(20, static[0])
    if static[0] == 24:
        assert bool(want.overflow)
    if static[1] == 1.5:  # bodies 4 and 5 share a wrapped key and are no pair
        pairs = set(zip(want.a[want.valid].tolist(), want.b[want.valid].tolist()))
        assert (4, 5) not in pairs


@pytest.mark.parametrize("method", ["sweep", "grid"])
def test_pile_steps_per_broad_phase_match_jax(method, monkeypatch):
    """Three steps of the 24-body pile with each broad phase, after 10 frames: every step's
    pair list, taken inside the step, equals the JAX function's on the same bounds, and the
    steps stay physical (contacts, no overflow)."""
    sim = _pile(tbp)
    sim.config = dataclasses.replace(sim.config, broadphase=method)
    sim.run(10, DT)
    cfg = sim.config
    static = ((cfg.max_pairs, cfg.sweep_window) if method == "sweep" else
              (cfg.max_pairs, cfg.grid_cell_size, cfg.grid_cell_capacity, cfg.grid_max_large))
    port_fn, lists = tsim.broad_phase, []

    def held(lo, hi, bodies, config):
        out = port_fn(lo, hi, bodies, config)
        want = _J[method](JVec3(*(jnp.asarray(t.numpy()) for t in lo)),
                          JVec3(*(jnp.asarray(t.numpy()) for t in hi)),
                          *(jnp.asarray(t.numpy()) for t in (bodies.kind, bodies.awake,
                                                             bodies.collision_group)), *static)
        lists.append((out, jax.tree_util.tree_map(np.asarray, want)))
        return out

    monkeypatch.setattr(tsim, "broad_phase", held)
    sim.run(3, DT)
    assert len(lists) == 3
    for got, want in lists:
        _same(got, want)
        assert int(want.valid.sum()) > 20
    assert int(sim.last_diag.contact_count) > 0 and not bool(sim.last_diag.overflow)
    assert tsim._broadphase_method(cfg) == method
