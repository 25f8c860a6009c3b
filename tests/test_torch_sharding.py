"""The port's sharded step and batched worlds (``bepuphysics2_tpu_torch.parallel``) over a
two-rank gloo group on the CPU, against the JAX package's ``parallel/sharding.py`` on a
two-device mesh.

- The scene of ``tests/test_sharding.py`` (``build_scene``: 12 spheres falling onto a box,
  a ball socket from a kinematic anchor): twenty frames of the port's ``sharded_step_fn``
  (the JAX test's five, then fifteen in which the spheres land, so that the caches hold
  contact records) against the JAX one at the JAX test's own bounds (rtol 2e-4, atol 2e-5)
  frame by frame,
  the bodies bit-identical on both ranks (replicated), each rank's cache shard (keys,
  colors, validity exactly; impulses at the same bounds) and joint impulses against the
  JAX shard of the same rows, the combined diagnostics exactly, and capacities that do not
  divide by the world size refused with the JAX package's ``ValueError``.
- The sleeping row of 8 spheres of ``tests/test_sharding.py``: after 40 sharded frames the
  awake set equals the JAX package's sharded one (every sphere asleep).
- Four worlds of the first scene from different seeds, two on each rank through
  ``batched_step_fn``: each bit-identical to a lone port ``step`` of the same world, and
  within 1e-5 of the JAX single-world ``step``.

The JAX package's ``batched_step_fn`` is not run here (its compile alone takes minutes on
the CPU); its single-world ``step`` is what it scans. The ranks are spawned processes
(``tests/torch_ranks.py``) that meet through a ``FileStore`` under ``tmp_path``; they run
while the JAX package compiles.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu.parallel import sharding as jshard
from bepuphysics2_tpu.simulation import step as jstep

import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.interop import (
    joint_banks_from_numpy, shapes_from_numpy, state_from_numpy,
)
from bepuphysics2_tpu_torch.parallel.sharding import _stack, replicate_state

from test_sharding import build_scene
from test_torch_general_win import _close_per_body
from test_torch_sim import _port_config
from torch_ranks import join_ranks, start_ranks

DT = 1 / 60.0
FRAMES = 20
SLEEP_FRAMES = 40
SEEDS = (3, 4, 5, 6)
BOUNDS = dict(rtol=2e-4, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scene_inputs(sim):
    """(JAX state, shapes, banks, present) and the port's inputs for the same scene."""
    present = tuple(sorted({int(t) for t in sim.shapes.types if t >= 0}))
    banks = {n: {k: v for k, v in s.device().items() if k != "impulse"}
             for n, s in sim.joints.items() if s.count > 0}
    port = dict(state=state_from_numpy(_np(sim.state), "cpu"),
                shapes=shapes_from_numpy(_np(sim.shapes.device()), "cpu"),
                banks=joint_banks_from_numpy(_np(banks), "cpu"), present=present,
                config=_port_config(sim.config), dt=DT)
    return (sim.state, sim.shapes.device(), banks, present), port


def _seeded_scene(seed):
    """``build_scene(n_dyn=4)`` with its spheres placed by ``seed``."""
    sim, config = build_scene(n_dyn=4)
    rng = np.random.default_rng(seed)
    for i in range(4):
        p = rng.uniform(-1.5, 1.5, 3)
        sim.set_pose(1 + i, position=(float(p[0]), 0.6 + 0.9 * i, float(p[2])))
    return sim


def _sleep_scene():
    sim = jbp.Simulation(jbp.SimConfig(
        body_capacity=64, max_pairs=256, substeps=2, num_colors=2, enable_sleep=True,
        sleep_time=0.15, use_pair_store=False, broadphase="brute"))
    g = sim.add_shape(jbp.Box(20.0, 0.5, 20.0))
    sim.add_static(jbp.StaticDescription(position=(0, -0.5, 0), shape=g))
    s = jbp.Sphere(0.5)
    ss = sim.add_shape(s)
    for i in range(8):
        sim.add_body(jbp.BodyDescription.dynamic((i * 1.5 - 5, 0.4995, 0), ss, 1.0, s))
    return sim


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks and the JAX runs, once for the module: the ranks start first and
    step while the JAX package compiles."""
    mesh = jshard.make_mesh(2)
    out = {}
    sim, config = build_scene()
    scene, port = _scene_inputs(sim)
    bad = dataclasses.replace(config, max_pairs=65)
    ssim = _sleep_scene()
    sscene, sport = _scene_inputs(ssim)
    wsims = [_seeded_scene(s) for s in SEEDS]
    worlds = [_scene_inputs(w) for w in wsims]
    wport = worlds[0][1]
    out.update(port=port, worlds=[w[1]["state"] for w in worlds], world_inputs=wport)
    ranks = start_ranks(2, {
        "sharded:scene": dict(port, frames=FRAMES, bad_config=_port_config(bad)),
        "sharded:sleep": dict(sport, frames=SLEEP_FRAMES),
        "batched": dict(wport, states=_stack(out["worlds"]))}, tmp_path_factory.mktemp("ranks"))
    try:
        state, shapes, banks, present = scene
        fn = jshard.sharded_step_fn(config, mesh, present_types=present)(state, shapes, banks)
        st = jshard.shard_state(state, mesh)
        frames = []
        for _ in range(FRAMES):
            st, diag = fn(st, shapes, banks, jnp.float32(DT))
            frames.append(_np(st.bodies))
        out["scene"] = dict(frames=frames, state=_np(st), diag=_np(diag))
        with pytest.raises(ValueError) as refused:
            jshard.sharded_step_fn(bad, mesh)
        out["refusal"] = str(refused.value)

        sstate, sshapes, sbanks, spresent = sscene
        sfn = jshard.sharded_step_fn(ssim.config, mesh, present_types=spresent)(
            sstate, sshapes, sbanks)
        sst = jshard.shard_state(sstate, mesh)
        for _ in range(SLEEP_FRAMES):
            sst, _ = sfn(sst, sshapes, sbanks, jnp.float32(DT))
        out["sleep_awake"] = np.asarray(sst.bodies.awake)

        _, wshapes, wbanks, wpresent = worlds[0][0]
        out["batched_jax"] = [_np(jstep(w[0][0], wshapes, wbanks, jnp.float32(DT),
                                        wsims[0].config, wpresent)[0].bodies) for w in worlds]
    finally:
        out["ranks"] = join_ranks(ranks)
    return out


def _bodies(b):
    return np.stack([np.asarray(c) for c in (*b.pos, *b.vel)])


def test_sharded_step_matches_jax_on_two_ranks(runs):
    r0, r1 = (r["sharded:scene"] for r in runs["ranks"])
    for f, want in enumerate(runs["scene"]["frames"]):
        np.testing.assert_allclose(_bodies(r0["bodies"][f]), _bodies(want), **BOUNDS,
                                   err_msg=f"frame {f + 1}")
        for field in ("pos", "orn", "vel", "omega"):
            np.testing.assert_array_equal(np.stack(getattr(r0["bodies"][f], field)),
                                          np.stack(getattr(r1["bodies"][f], field)))
    moved = _bodies(runs["scene"]["frames"][-1]) - _bodies(runs["port"]["state"].bodies)
    assert np.abs(moved).max() > 1e-2


def test_sharded_caches_and_diagnostics_match_jax(runs):
    want = runs["scene"]["state"]
    n = want.cache.key.shape[0] // 2
    live = 0
    for r, res in enumerate(runs["ranks"]):
        got = res["sharded:scene"]
        rows = slice(r * n, (r + 1) * n)
        for f in ("key", "color", "valid", "body_a", "body_b"):
            np.testing.assert_array_equal(getattr(got["cache"], f), getattr(want.cache, f)[rows],
                                          err_msg=f"rank {r} cache {f}")
        for f in ("penetration", "twist"):
            np.testing.assert_allclose(getattr(got["cache"], f), getattr(want.cache, f)[rows],
                                       **BOUNDS, err_msg=f"rank {r} cache {f}")
        for g, w in zip(got["cache"].tangent, want.cache.tangent):
            np.testing.assert_allclose(g, np.asarray(w)[rows], **BOUNDS)
        jn = want.joint_impulses["ball_socket"].shape[0] // 2
        np.testing.assert_allclose(got["joint_impulses"]["ball_socket"],
                                   want.joint_impulses["ball_socket"][r * jn:(r + 1) * jn],
                                   **BOUNDS)
        live += int((got["cache"].key != 2**31 - 1).sum())
        d, wd = got["diag"], runs["scene"]["diag"]
        for f in ("pair_count", "contact_count", "overflow", "overflow_src", "demand"):
            np.testing.assert_array_equal(getattr(d, f), getattr(wd, f), err_msg=f)
        assert got["collectives"] > 0
    assert live == int(runs["scene"]["diag"].pair_count) > 0
    assert np.abs(want.joint_impulses["ball_socket"]).max() > 0


def test_capacities_that_do_not_divide_are_refused_as_jax_refuses(runs):
    for res in runs["ranks"]:
        assert res["sharded:scene"]["refusal"] == runs["refusal"]


def test_sharded_sleep_matches_jax(runs):
    want = runs["sleep_awake"]
    assert not want[1:9].any(), "the JAX scene failed to sleep"
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res["sharded:sleep"]["bodies"][-1].awake, want)


def test_batched_worlds_match_lone_steps_and_jax(runs):
    inp = runs["world_inputs"]
    got = [jax.tree_util.tree_map(lambda x: x[i], res["batched"]["states"])
           for res in runs["ranks"] for i in range(2)]
    for w, (world, g) in enumerate(zip(runs["worlds"], got)):
        lone, _ = tsim.step(world, inp["shapes"], inp["banks"], DT, inp["config"],
                            inp["present"])
        for f in ("pos", "orn", "vel", "omega"):
            for a, b in zip(getattr(lone.bodies, f), getattr(g.bodies, f)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"world {w} {f}")
            _close_per_body(getattr(lone.bodies, f), getattr(runs["batched_jax"][w], f), 1e-5,
                            f"world {w} {f}")
        np.testing.assert_array_equal(lone.store.color.numpy(), g.store.color)
    p = [np.asarray(g.bodies.pos.x) for g in got]
    assert not all(np.array_equal(p[0], q) for q in p[1:])  # the seeds differ
    tiled = replicate_state(runs["worlds"][0], 3)
    assert tiled.bodies.pos.x.shape == (3,) + tuple(runs["worlds"][0].bodies.pos.x.shape)
    assert all(torch.equal(tiled.store.body_a[i], runs["worlds"][0].store.body_a)
               for i in range(3))
