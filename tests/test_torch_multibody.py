"""The multi-body joints in the port's solve against the JAX package on the CPU: the rest of
queue 1 item 15 (the ``mb_names`` path of ``solve_all``).

A small scene holds an area constraint (bodies 0-2), a volume constraint (bodies 0-3),
two-body joints (a swivel hinge between bodies 4 and 5, a ball socket between 1 and 4, a center
distance between 2 and 4) and a one-body servo on body 5, beside the spheres' contacts
with a static ground box. Two colors, so that the multi-body records share bodies with the
contacts and the other joints past what the colors hold: some of them solve in the
Jacobi pass, and their valence counts every group (contacts, two-body and multi-body
joints). ``max_pairs`` 1,024 (a store page of 128), so the JAX package takes its Pallas
layout with ``backend="pallas"`` (its K3 in interpret mode).

One port step (``simulation.step``, through the port's ``solve_all``) from each of the
JAX package's first frames against the JAX package's next state: bodies, joint impulses
and the store's impulses within 1e-5, joint colors exact.
"""
import numpy as np
import pytest
import torch

import jax

import bepuphysics2_tpu as jbp

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.interop import (
    joint_banks_from_numpy, shapes_from_numpy, state_from_numpy, state_to_numpy,
)

DT = 1 / 60
FRAMES = 4
MB = ("area", "volume")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(mod, **overrides):
    """The scene in the JAX package (``mod`` jbp) or the port (``mod`` tbp, on the CPU)."""
    kw = dict(body_capacity=16, max_pairs=1024, substeps=2, num_colors=2,
              velocity_iterations=2, enable_sleep=False, solver_backend="pallas")
    kw.update(overrides)
    sim = (mod.Simulation(mod.SimConfig(**kw)) if mod is jbp
           else mod.Simulation(mod.SimConfig(**kw), device="cpu"))
    ground = sim.add_shape(mod.Box(20.0, 0.5, 20.0))
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=ground))
    s = mod.Sphere(0.3)
    ss = sim.add_shape(s)
    pos = np.array([[0.0, 0.29, 0.0], [0.9, 0.29, 0.1], [0.3, 0.29, 0.8], [0.4, 0.9, 0.3],
                    [1.8, 0.29, 0.9], [2.4, 0.29, 1.0]])
    h = [sim.add_body(mod.BodyDescription.dynamic(tuple(p), ss, 1.0, s)) for p in pos]
    ab, ac, ad = pos[1] - pos[0], pos[2] - pos[0], pos[3] - pos[0]
    # Targets a few percent off the current shape: the constraints push from the first step.
    sim.add_constraint("area", h[:3],
                       target_scaled_area=1.03 * float(np.linalg.norm(np.cross(ab, ac))))
    sim.add_constraint("volume", h[:4],
                       target_scaled_volume=0.97 * float(np.cross(ab, ac) @ ad))
    sim.add_constraint("ball_socket", [h[1], h[4]], local_offset_a=(0.45, 0.0, 0.4),
                       local_offset_b=(-0.45, 0.0, -0.4))
    # A swivel hinge, not a hinge: at rest the hinge's error angles are arccos of values
    # within rounding of 1, where an ulp of input moves the angle by ~3e-4 rad, and XLA's
    # fused arithmetic and the port's rounding differ by that much (both packages).
    sim.add_constraint("swivel_hinge", h[4:], local_offset_a=(0.3, 0.0, 0.05),
                       local_swivel_axis_a=(0.0, 0.0, 1.0), local_offset_b=(-0.3, 0.0, -0.05),
                       local_hinge_axis_b=(1.0, 0.0, 0.0))
    sim.add_constraint("center_distance", [h[2], h[4]],
                       target_distance=0.97 * float(np.linalg.norm(pos[4] - pos[2])))
    sim.add_constraint("one_body_linear_servo", [h[5]], local_offset=(0.0, 0.3, 0.0),
                       target=tuple(pos[5] + (0.0, 0.32, 0.0)))
    return sim


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def carried():
    """The JAX scene's states after 0 ... FRAMES frames of its own steps, its joint banks,
    shapes and present types."""
    sim = build(jbp)
    states = [_np(sim.state)]
    for _ in range(FRAMES):
        sim.timestep(DT)
        states.append(_np(sim.state))
    banks = {n: {k: np.asarray(v) for k, v in st.device().items() if k != "impulse"}
             for n, st in sim.joints.items() if st.count > 0}
    return dict(states=states, banks=banks, shapes=_np(sim.shapes.device()),
                present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_multibody_step_matches_jax_pallas(carried, frame):
    before, want = carried["states"][frame], carried["states"][frame + 1]
    cfg = build(tbp).config
    state, _ = tsim.step(state_from_numpy(before, "cpu"),
                         shapes_from_numpy(carried["shapes"], "cpu"),
                         joint_banks_from_numpy(carried["banks"], "cpu"), DT, cfg,
                         carried["present"])
    got = state_to_numpy(state)
    for f in ("pos", "orn", "vel", "omega"):
        for g, w in zip(getattr(got.bodies, f), getattr(want.bodies, f)):
            _close(g, w, f)
    assert sorted(got.joint_impulses) == sorted(want.joint_impulses)
    for n in want.joint_impulses:
        _close(got.joint_impulses[n], want.joint_impulses[n], n)
        np.testing.assert_array_equal(got.joint_colors[n], want.joint_colors[n], err_msg=n)
    for f in ("imp_pen", "imp_tx", "imp_ty", "imp_tw"):
        _close(getattr(got.store, f), getattr(want.store, f), f)
    np.testing.assert_array_equal(got.store.live, want.store.live)
    moved = np.abs(np.stack(want.bodies.pos) - np.stack(before.bodies.pos)).max()
    assert moved > 1e-4 and all(np.abs(want.joint_impulses[n]).max() > 1e-4 for n in MB)


def test_multibody_records_reach_the_jacobi_pass(carried):
    """With two colors some multi-body record solves in the Jacobi pass (its persisted
    color -1) on some frame, in the JAX package's run the test above follows."""
    jacobi = [int((np.asarray(s.joint_colors[n])[:1] < 0).sum())
              for s in carried["states"][1:] for n in MB]
    assert sum(jacobi) > 0
    assert all(int(np.asarray(s.store.live).sum()) > 0 for s in carried["states"][1:])
