"""Queue 1 item 27: ``bench.py``'s colosseum through the port against the JAX package on the
CPU, at 2 colosseums of 24 bricks a ring and 3 layers (144 bodies, brute force, K1's plain
version), built by ``__graft_entry__._build_colosseum_sim`` and by the port's
``models.build_colosseum_sim``. (A ring of 8 is no colosseum: its bricks, 2 m long on a
2.1 m pitch, meet at 45 degrees and spawn interpenetrating at the inner corners, fly
apart at up to 5 m/s and have not settled after 240 frames; a ring of 24 turns 15 degrees
a brick and settles by frame 120.)

- The builders agree: the initial states are equal exactly.
- The first 20 frames stay within the JAX package's own pile envelope (5e-3 max, 1e-4
  median; ``tests/test_pallas_sweep.py``).
- Sleep under load: after the same steps the same bodies are awake (none, once settled);
  after the same topple (4 m/s added to the x velocity of every body of colosseum 0,
  through ``get_body`` and ``set_velocity``) and 16 more steps, the same bodies are awake,
  all of them in colosseum 0. (bench.py runs 32; at this size the colosseums stand 4.9 m
  apart, not bench.py's 9.7 m, and by frame 28 a brick of colosseum 0 comes near enough
  to colosseum 1 for a speculative pair, which wakes it, in both packages.)
- ``run_colosseum``, the port's copy of ``bench.py``'s sequence, on the same scene:
  settled under 5%, and the topple wakes colosseum 0 alone.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

from bepuphysics2_tpu_torch.interop import state_to_numpy
from bepuphysics2_tpu_torch.models import build_colosseum_sim, run_colosseum

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _build_colosseum_sim  # noqa: E402

DT = 1 / 60
SIZE = dict(n_bodies=144, ring_count=24, layers=3)
ENVELOPE = 20  # frames held to the pile envelope
SETTLE = 120  # frames after which both packages have put every island to sleep
TOPPLE = 16  # frames after the topple: see the docstring


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_positions(sim):
    sim._sync_from_device()
    return np.stack([sim._host.px, sim._host.py, sim._host.pz])


def _port_positions(sim):
    sim._sync_from_device()
    return np.stack([sim._host.px, sim._host.py, sim._host.pz])


def _awake(sim, handles):
    sim._sync_from_device()
    return {int(h) for h in handles if sim._host.awake[int(h)]}


def _topple(sim, handles, col_of):
    for h in np.asarray(handles)[col_of == 0]:
        v = sim.get_body(int(h))[2]
        sim.set_velocity(int(h), linear=(float(v[0]) + 4.0, float(v[1]), float(v[2])))


@pytest.fixture(scope="module")
def runs():
    """Both packages through the same frames: positions over the envelope's frames, the
    awake sets once settled and after the topple, the initial states."""
    out = {}
    for key, build in (("jax", lambda: _build_colosseum_sim(**SIZE)),
                       ("port", lambda: build_colosseum_sim(**SIZE, device="cpu"))):
        sim, config, handles, col_of = build()
        rec = dict(handles=list(handles), col_of=col_of, config=config,
                   state0=(state_to_numpy(sim.state) if key == "port"
                           else jax.tree_util.tree_map(np.asarray, sim.state)))
        pos = _jax_positions if key == "jax" else _port_positions
        traj = []
        for _ in range(ENVELOPE):
            sim.timestep(DT)
            traj.append(pos(sim))
        rec["traj"] = np.stack(traj)
        sim.run(SETTLE - ENVELOPE, DT)
        rec["settled"] = _awake(sim, handles)
        _topple(sim, handles, col_of)
        sim.run(TOPPLE, DT)
        rec["toppled"] = _awake(sim, handles)
        out[key] = rec
    return out


def test_builders_agree(runs):
    j, p = runs["jax"], runs["port"]
    assert j["handles"] == p["handles"] and (j["col_of"] == p["col_of"]).all()
    assert len(p["handles"]) == 144 and sorted(set(p["col_of"])) == [0, 1]
    for f in ("body_capacity", "max_pairs", "substeps", "num_colors", "broadphase",
              "enable_sleep"):
        assert getattr(p["config"], f) == getattr(j["config"], f), f
    jb, pb = j["state0"].bodies, p["state0"].bodies
    for f in ("pos", "orn", "vel", "omega", "inv_inertia"):
        for g, w in zip(getattr(pb, f), getattr(jb, f)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    for f in ("inv_mass", "kind", "shape", "awake"):
        np.testing.assert_array_equal(getattr(pb, f), np.asarray(getattr(jb, f)), err_msg=f)


def test_first_frames_within_the_pile_envelope(runs):
    diff = np.abs(runs["port"]["traj"] - runs["jax"]["traj"])
    assert diff.max() < 5e-3 and np.median(diff) < 1e-4, (diff.max(), np.median(diff))
    assert np.abs(runs["jax"]["traj"][-1] - runs["jax"]["traj"][0]).max() > 1e-4


def test_sleep_and_topple_wake_the_same_bodies(runs):
    j, p = runs["jax"], runs["port"]
    assert p["settled"] == j["settled"] == set()
    col0 = {h for h, c in zip(p["handles"], p["col_of"]) if c == 0}
    assert p["toppled"] == j["toppled"]
    assert p["toppled"] <= col0 and len(p["toppled"]) >= len(col0) // 2


def test_run_colosseum_settles_and_topples_one(runs):
    sim, _, handles, col_of = build_colosseum_sim(**SIZE, device="cpu")
    out = run_colosseum(sim, handles, col_of, DT, settle_runs=4, timed=8)
    assert out["settled"] < 0.05 and out["curve"][-1] == out["settled"]
    col0 = {int(h) for h in np.asarray(handles)[col_of == 0]}
    assert out["awake_handles"] <= col0 and len(out["awake_handles"]) >= len(col0) // 2
    assert 0.25 <= out["post_topple"] <= 0.5
    (p0, a0), (p1, a1) = out["settled_window"]
    asleep = ~a0.numpy()
    assert (p0.numpy()[:, asleep] == p1.numpy()[:, asleep]).all()
    assert not out["autosize"]["overflow"]
