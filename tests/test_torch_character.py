"""Queue 1 item 20's character (``models.Character``) through the port against the JAX
package on the CPU.

- The JAX package's character scene (``tests/test_models.py``'s ``ground_sim`` and
  ``Character``): one port step from each of 3 carried JAX states (falling, landed, and
  the tick after a ``move``) against the JAX package's next state, every body within
  1e-4 in pose and velocity; the builders give the same bodies and the same motor
  record. One dynamic body with one motor and one ground contact: the JAX package's XLA
  solve and the port's colored one take the same order.
- The port on its own, by behaviour at the JAX test's thresholds: the character lands and
  is supported, walks more than 1 m in 120 ticks, and rises more than 0.5 m in a jump.
"""
import numpy as np
import pytest
import torch

import jax

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu import models as jmodels

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch import models as tmodels
from bepuphysics2_tpu_torch.interop import (
    joint_banks_from_numpy, shapes_from_numpy, state_from_numpy, state_to_numpy,
)

from test_torch_shape_pile import _body_gap

DT = 1 / 60
TOL = 1e-4
CARRIED = (1, 30, 61)  # falling, landed, the tick after a move((2, 0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scene is small: one torch thread steps it faster than a pool does, and leaves
    the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def character_scene(mod, **over):
    """``tests/test_models.py``'s character scene: ``ground_sim(body_capacity=16)`` and a
    ``Character`` at (0, 1.2, 0)."""
    cfg = dict(body_capacity=16, max_pairs=512, substeps=4, velocity_iterations=2,
               num_colors=8, joint_capacity=128, max_compound_pairs=16, children_per_pair=4,
               child_window=16)
    cfg.update(over)
    sim = (mod.Simulation(mod.SimConfig(**cfg)) if mod is jbp
           else mod.Simulation(mod.SimConfig(**cfg), device="cpu"))
    g = sim.add_shape(mod.Box(50.0, 0.5, 50.0))
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=g))
    ch = (jmodels if mod is jbp else tmodels).Character(sim, position=(0, 1.2, 0))
    return sim, ch


def _np(tree):
    """Numpy copies of a JAX tree: ``np.asarray`` of a CPU array can view its buffer,
    which the JAX step donates and overwrites on the next step."""
    return jax.tree_util.tree_map(np.array, tree)


def _banks(sim):
    """Copies of the joint banks: a JAX array on the CPU can share its buffer with the
    host record that ``update_constraint`` later rewrites."""
    return {n: {k: np.array(v) for k, v in st.device().items() if k != "impulse"}
            for n, st in sim.joints.items() if st.count > 0}


@pytest.fixture(scope="module")
def carried():
    """The JAX scene's state before and after each carried frame, with the joint banks
    that step took."""
    sim, ch = character_scene(jbp)
    out = {}
    for frame in range(1, max(CARRIED) + 1):
        if frame == 61:
            ch.move((2.0, 0.0))
        if frame in CARRIED:
            before, banks = _np(sim.state), _banks(sim)
        sim.timestep(DT)
        if frame in CARRIED:
            out[frame] = (before, banks, _np(sim.state))
    out["shapes"] = _np(sim.shapes.device())
    out["present"] = tuple(sorted({int(t) for t in sim.shapes.types if t >= 0}))
    return out


def test_builder_equals_jax():
    (jsim, jch), (tsim_, tch) = character_scene(jbp), character_scene(tbp)
    jstate, tstate = _np(jsim.state).bodies, state_to_numpy(tsim_.state).bodies
    for f in tstate._fields:
        for g, w in zip(jax.tree_util.tree_leaves(getattr(tstate, f)),
                        jax.tree_util.tree_leaves(getattr(jstate, f))):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)
    assert (tch.body, tch.half_height, tch.radius) == (jch.body, jch.half_height, jch.radius)
    (jn, jb), = _banks(jsim).items()
    tb = {k: v.numpy() for k, v in tsim_.joints[jn].device("cpu").items() if k != "impulse"}
    for f in ("bodies", "valid", "prestep"):
        np.testing.assert_array_equal(tb[f], jb[f], err_msg=f)


@pytest.mark.parametrize("frame", CARRIED)
def test_character_step_matches_jax(carried, frame):
    before, banks, want = carried[frame]
    state, _ = tsim.step(state_from_numpy(before, "cpu"),
                         shapes_from_numpy(carried["shapes"], "cpu"),
                         joint_banks_from_numpy(banks, "cpu"), DT,
                         character_scene(tbp)[0].config, carried["present"])
    gap = _body_gap(state_to_numpy(state), want)
    assert gap.max() <= TOL, gap.tolist()


def test_character_walks_and_jumps():
    sim, ch = character_scene(tbp)
    sim.run(60, DT)  # land
    assert ch.supported(), "the character should stand on the ground"
    for _ in range(120):
        ch.move((2.0, 0.0))
        sim.timestep(DT)
    pos = sim.get_body(ch.body)[0]
    assert pos[0] > 1.0, f"the character did not walk: {pos}"
    ch.move((0.0, 0.0), jump_speed=5.0)
    max_y = pos[1]
    for _ in range(30):
        sim.timestep(DT)
        max_y = max(max_y, sim.get_body(ch.body)[0][1])
    assert max_y > pos[1] + 0.5, f"the character did not jump: {max_y} vs {pos[1]}"
