"""Queue 1 item 22's car and tank through the port against the JAX package on the CPU.

- The builders agree exactly: ``models.SimpleCar`` in ``tests/test_models.py``'s car scene
  and ``models.Tank`` in its tank scene give the JAX package's bodies, shapes and joint
  records (bodies, liveness and prestep of every type's bank).
- One scene holds both vehicles falling free (the car's 4 joint types and the tank's 6),
  ``max_pairs`` 1,024 (a store page of 128), so the JAX package takes its Pallas layout
  with ``backend="pallas"`` (its K3 in interpret mode). One port step from each of 3
  carried JAX states against the JAX package's next state, every joint color exactly,
  every body of a vehicle within 1e-4 (pose and velocity), or within twice the largest
  of the JAX package's own one-step spread over that vehicle's bodies where that is
  larger: its step from the same state with every orientation or position component
  nudged by 1e-7 relative, about an ulp (``nudged_spread``). The car's is ~6e-8 under the orientation nudge. The tank's is
  7.5e-3 to 1.7e-2 on frames 1-3: it comes through the tank's hinges and twist servos,
  which the car lacks, and which measure angles as the ``acos`` of a dot product near 1
  (the reference's formulas), where one ulp of the dot is 3.5e-4 rad; XLA's fused CPU
  arithmetic and the port round that dot differently on some steps
  (``python3 tools/vehicles_vs_jax.py --nudge`` prints both).
- On the ground a wheel's support perpendicular to its axle ties between the rim's two
  edges, decided by rounding (``tests/test_torch_shape_pile.py``), so the vehicles on the
  ground are held by their behaviour on the card (``chip_smoke.py`` phase 31), not step
  by step.
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

from test_torch_shape_pile import _body_gap, nudged_spread


DT = 1 / 60
CARRIED = (1, 2, 3)  # frames whose state one port step is taken from
TOL = 1e-4
CAR_BODIES, TANK_BODIES = 5, 9  # a chassis and 4 wheels; a hull, turret, barrel, 6 wheels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scene is small: one torch thread steps it faster than a pool does, and leaves
    the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim(mod, ground, **kw):
    """A simulation with a static box ground (half extent, centre height)."""
    sim = (mod.Simulation(mod.SimConfig(**kw)) if mod is jbp
           else mod.Simulation(mod.SimConfig(**kw), device="cpu"))
    g = sim.add_shape(mod.Box(ground[0], 0.5, ground[0]))
    sim.add_static(mod.StaticDescription(position=(0, ground[1], 0), shape=g))
    return sim


def car_scene(mod):
    """``tests/test_models.py``'s car scene (``ground_sim(body_capacity=32)``)."""
    sim = _sim(mod, (50.0, -0.5), body_capacity=32, max_pairs=512, substeps=4,
               velocity_iterations=2, num_colors=8, joint_capacity=128, max_compound_pairs=16,
               children_per_pair=4, child_window=16)
    (jmodels if mod is jbp else tmodels).SimpleCar(sim, position=(0, 0.8, 0))
    return sim


def tank_scene(mod):
    """``tests/test_models.py``'s tank scene, CCD on as there (``max_ccd_pairs`` 4)."""
    sim = _sim(mod, (120.0, -0.25), body_capacity=64, max_pairs=1024, substeps=4,
               num_colors=8, joint_capacity=64, max_ccd_pairs=4, enable_sleep=False)
    models = jmodels if mod is jbp else tmodels
    models.Tank(sim, position=(0.0, 1.0, 0.0), wheels_per_tread=3)
    return sim


def both_scene(mod):
    """The car and the tank side by side, in one configuration, falling free: the ground
    lies 50 m below (the contacts of wheels on ground are held in
    ``tests/test_torch_convex.py`` and ``tests/test_torch_shape_pile.py``)."""
    sim = _sim(mod, (120.0, -50.0), body_capacity=64, max_pairs=1024, substeps=4,
               num_colors=8, joint_capacity=128, enable_sleep=False, solver_backend="pallas")
    models = jmodels if mod is jbp else tmodels
    models.SimpleCar(sim, position=(-4.0, 0.8, 0.0))
    models.Tank(sim, position=(4.0, 1.0, 0.0), wheels_per_tread=3)
    return sim


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(x):
    if isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)
    else:
        yield np.asarray(x)


def _banks(sim, device=None):
    return {n: {k: np.asarray(v if device is None else v.numpy()) for k, v in
                (st.device() if device is None else st.device(device)).items() if k != "impulse"}
            for n, st in sim.joints.items() if st.count > 0}


@pytest.mark.parametrize("scene", [car_scene, tank_scene], ids=["car", "tank"])
def test_builders_equal_jax(scene):
    jsim, tsim_ = scene(jbp), scene(tbp)
    jstate, tstate = _np(jsim.state).bodies, state_to_numpy(tsim_.state).bodies
    for f in tstate._fields:
        for g, w in zip(_leaves(getattr(tstate, f)), _leaves(getattr(jstate, f))):
            np.testing.assert_array_equal(g, w, err_msg=f)
    jshapes, tshapes = _np(jsim.shapes.device()), tsim_.shapes.device("cpu")
    for f in jshapes._fields:
        if f in tshapes._fields:
            np.testing.assert_array_equal(getattr(tshapes, f).numpy(), getattr(jshapes, f),
                                          err_msg=f)
    jb, tb = _banks(jsim), _banks(tsim_, "cpu")
    assert sorted(jb) == sorted(tb) and len(jb) >= 4
    for n in jb:
        for f in ("bodies", "valid", "prestep"):
            np.testing.assert_array_equal(tb[n][f], jb[n][f], err_msg=f"{n} {f}")


@pytest.fixture(scope="module")
def carried():
    """The JAX scene's states after 0 ... the last carried frame + 1, its joint banks,
    shapes and present types."""
    sim = both_scene(jbp)
    states = {0: _np(sim.state)}
    for frame in range(1, max(CARRIED) + 2):
        sim.timestep(DT)
        states[frame] = _np(sim.state)
    out = dict(states=states, banks=_banks(sim), shapes=_np(sim.shapes.device()),
               present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})))
    out["jax_sim"] = sim  # for ``nudged_spread``, where a step needs it
    return out


@pytest.mark.parametrize("frame", CARRIED)
def test_vehicles_step_matches_jax_pallas(carried, frame):
    """Every body within 1e-4 (pose and velocity), or twice the JAX package's own spread
    under an ulp's nudge where that is larger (see the module's docstring); every joint
    color exactly."""
    before, want = carried["states"][frame], carried["states"][frame + 1]
    state, _ = tsim.step(state_from_numpy(before, "cpu"),
                         shapes_from_numpy(carried["shapes"], "cpu"),
                         joint_banks_from_numpy(carried["banks"], "cpu"), DT,
                         both_scene(tbp).config, carried["present"])
    got = state_to_numpy(state)
    gap = _body_gap(got, want)
    car, tank = slice(1, 1 + CAR_BODIES), slice(1 + CAR_BODIES, 1 + CAR_BODIES + TANK_BODIES)
    assert (gap[car] <= TOL).all(), gap[car].tolist()
    if gap[tank].max() > TOL:
        spread = nudged_spread(carried["jax_sim"], before, want, seed=frame)
        bound = max(TOL, 2 * spread[tank].max())
        assert gap[tank].max() <= bound, (gap[tank].tolist(), bound)
    assert sorted(got.joint_impulses) == sorted(want.joint_impulses)
    for n in want.joint_impulses:
        np.testing.assert_array_equal(got.joint_colors[n], want.joint_colors[n], err_msg=n)
    assert np.abs(np.stack(want.bodies.vel)[:, car]).max() > 0.1  # falling
