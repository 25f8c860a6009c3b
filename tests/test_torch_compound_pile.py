"""Slice 4 of the PyTorch port against the JAX package on the CPU: a contact-only scene
with a compound bank, which both packages solve in their whole-solve branch (one K1
launch over the store's pages and then the compound buckets, slices of the store's page;
JAX ``solve_all`` :1785-1856), on the compound pile (``models.build_compound_pile_sim``:
18 spheres and boxes in the ragdoll tube's spinning tube, no joints, 2 substeps, 4
colors).

- ``solve_all`` from carried JAX states (frames 0, 3 and 10; the compound bank holds live
  rows in each), fed the same stage outputs in both packages, against the JAX
  ``solve_all`` with ``backend="pallas"`` (its K1 in interpret mode): bodies per body
  within 1e-5, absolute and relative; both banks' impulses within 1e-5; colors, overflow
  and demand exact. The helpers are ``tests/test_torch_general_win.py``'s.
- Ten frames of the pile through the port alone stay physical.
"""
import numpy as np
import pytest
import torch

import bepuphysics2_tpu as jbp

from bepuphysics2_tpu_torch.models import build_compound_pile_sim
from bepuphysics2_tpu_torch.models.scenes import compound_pile_positions
from bepuphysics2_tpu_torch.ops import sweep

from test_torch_general_win import DT, _carry, _close, _hold, _positions, _solve_both

N_CPILE = 18
CPILE_FRAMES = (0, 3, 10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_compound_pile():
    """The port's ``build_compound_pile_sim(18, substeps=2, num_colors=4)`` in the JAX
    package: the ragdoll tube's spinning tube (``__graft_entry__``) with spheres and
    boxes."""
    n_slots = N_CPILE + 8
    sim = jbp.Simulation(jbp.SimConfig(
        body_capacity=n_slots + 8, max_pairs=max(1024, 8 * n_slots),
        max_compound_pairs=max(256, 2 * n_slots), children_per_pair=8, substeps=2,
        num_colors=4))
    radius, n_panels = 4.5, 24
    length = max(8.0, (N_CPILE // 9) * 1.0 + 4.0)
    panel_w = 2 * np.pi * radius / n_panels * 0.62
    box_id = sim.add_shape(jbp.Box(panel_w * 0.5, 0.25, length * 0.5))
    children = []
    for k in range(n_panels):
        th = 2 * np.pi * k / n_panels
        q = (0.0, 0.0, float(np.sin(th * 0.5)), float(np.cos(th * 0.5)))
        children.append((box_id, (radius * -np.sin(th), radius * np.cos(th), 0.0), q))
    tube = sim.add_body(jbp.BodyDescription.kinematic(
        (0.0, 6.0, 0.0), sim.add_shape(jbp.Compound.build(children))))
    sim.set_velocity(tube, angular=(0.0, 0.0, 1.0))
    sphere, box = jbp.Sphere(0.3), jbp.Box(0.3, 0.3, 0.3)
    sphere_id, box_id = sim.add_shape(sphere), sim.add_shape(box)
    for i, p in enumerate(compound_pile_positions(N_CPILE)):
        sid, obj = (sphere_id, sphere) if i % 2 == 0 else (box_id, box)
        sim.add_body(jbp.BodyDescription.dynamic(tuple(float(c) for c in p), sid, 1.0, obj))
    return sim


@pytest.fixture(scope="module")
def jax_cpile():
    return _carry(_jax_compound_pile(), CPILE_FRAMES)


@pytest.mark.parametrize("frame", CPILE_FRAMES)
def test_compound_contact_only_solve_matches_jax_pallas(jax_cpile, frame):
    """The store and compound impulses, the compound colors, bodies, overflow and demand
    of one solve, from identical stage outputs, against the JAX package's whole-solve
    branch."""
    got, want, st, carried = _solve_both(jax_cpile, frame, "pallas", True)
    assert int(st["cps"].valid.sum()) > 0
    _hold(got, want, carried, [])
    assert len(got[1]) == 2  # the store's and the compound bank's impulses


def test_compound_pile_builder_and_frames_stay_physical(jax_cpile):
    """The port's compound pile gives the JAX scene's state; ten port frames (one K1 solve
    per step, its plain version here) stay finite and inside the tube, with no overflow."""
    sim, _ = build_compound_pile_sim(N_CPILE, substeps=2, num_colors=4, device="cpu")
    want = jax_cpile["states"][0].bodies
    _close(torch.stack(list(sim.state.bodies.pos)), np.stack(want.pos), 0, "pos")
    before = sweep.solve_substeps_contacts.launches
    ovf = False
    for _ in range(10):
        sim.timestep(DT)
        ovf = ovf or bool(sim.last_diag.overflow)
    got = _positions(sim)
    dyn = sim._host.kind == 1
    assert np.isfinite(got).all() and not ovf and int(sim.last_diag.contact_count) > 0
    assert (np.hypot(got[0][dyn], got[1][dyn] - 6.0) < 4.5).all()  # inside the tube
    assert sweep.solve_substeps_contacts.launches == before  # the CPU runs the plain K1
