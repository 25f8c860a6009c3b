"""Queue 1 item 11 of the PyTorch port against the JAX package on the CPU: the solver's
iteration schedule (``SolveConfig.iteration_schedule``, the reference's
VelocityIterationScheduler, SolveDescription.cs:17) and the integrator's velocity
callback (``IntegratorConfig.velocity_callback``, IPoseIntegratorCallbacks.IntegrateVelocity,
PoseIntegrator.cs:42).

Either one takes a scene off the whole-solve kernels K1 and K2, in both packages: a
store-only scene then runs the general path's substep loop with each substep's own
iteration count, its pair store through K3 on the page layout (one launch per substep,
carrying that substep's iterations, as the JAX package calls its kernel for a lone
contact bank) and through K4 on the windowed layout (one launch per iteration).

- ``integrate_velocities`` with one radial-gravity callback written once per package, on
  seeded numpy state: within 1e-6 (the packages round the callback's f32 arithmetic alike
  up to an ulp of a ~10 m/s velocity).
- ``iterations_for``, and a schedule shorter than the substeps, which fails in both.
- The 24-body pile of ``tests/test_torch_sim.py`` (``max_pairs`` 1,024, so the store's
  page is 128 and the JAX package takes its Pallas layout) with the schedule (2, 1, 3) and
  the callback (gravity of 10 toward a point 1,000 m below the ground, linear damping
  0.05/s): one port step from each of the first ten frames of the JAX package's own run
  (``backend="pallas"``, its K3 in interpret mode) against the JAX package's next state,
  within 1e-5. The windowed layout is ``tests/test_torch_schedule_win.py``'s.
- Routing, the port alone: a store-only scene with either setting calls K3 (or K4)
  as above and never K1 or K2; a schedule of ones gives the bits of
  ``velocity_iterations=1`` forced onto the same path, and a callback that computes the
  default gravity and damping the bits of the default integration there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bepuphysics2_tpu as jbp
import bepuphysics2_tpu.simulation as jsim
from bepuphysics2_tpu.integrator import IntegratorConfig as JIntegratorConfig
from bepuphysics2_tpu.integrator import integrate_velocities as jintegrate_velocities
from bepuphysics2_tpu.solver.solve import SolveConfig as JSolveConfig
from bepuphysics2_tpu.utils.vec import Vec3 as JVec3

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.integrator import IntegratorConfig, integrate_velocities
from bepuphysics2_tpu_torch.interop import shapes_from_numpy, state_from_numpy, state_to_numpy
from bepuphysics2_tpu_torch.ops import sweep
from bepuphysics2_tpu_torch.solver import solve as tsolve
from bepuphysics2_tpu_torch.solver.solve import SolveConfig
from bepuphysics2_tpu_torch.utils.vec import Vec3

DT = 1 / 60
SCHEDULE = (2, 1, 3)
FRAMES = 10
CENTRE = (0.0, -1000.5, 0.0)  # 1,000 m below the ground box's centre


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def radial_gravity(vec3, sqrt):
    """A velocity callback for one package (its Vec3 and sqrt): gravity of magnitude 10
    toward ``CENTRE`` and a linear damping of 0.05/s, from the state alone."""
    def callback(state, dt):
        rx, ry, rz = (CENTRE[0] - state.pos.x, CENTRE[1] - state.pos.y,
                      CENTRE[2] - state.pos.z)
        k = 10.0 / sqrt(rx * rx + ry * ry + rz * rz)
        return (state.vel + vec3(rx * k, ry * k, rz * k) * dt) * (1.0 - 0.05) ** dt, state.omega
    return callback


JAX_CALLBACK = radial_gravity(JVec3, jnp.sqrt)
PORT_CALLBACK = radial_gravity(Vec3, torch.sqrt)


@dataclasses.dataclass(frozen=True)
class JaxScheduleConfig(jbp.SimConfig):
    """The JAX SimConfig with an iteration schedule: there only its SolveConfig has one,
    so this hands it on (the port's SimConfig carries the field itself)."""

    iteration_schedule: tuple = None

    def solve_config(self):
        return dataclasses.replace(super().solve_config(),
                                   iteration_schedule=self.iteration_schedule)


def schedule_pile(mod, **overrides):
    """``tests/test_torch_sim.py``'s 24-body pile with ``max_pairs`` 1,024, 3 substeps, the
    schedule (2, 1, 3) and the radial callback, in the JAX package (``mod`` jbp) or the
    port (``mod`` tbp, on the CPU)."""
    jax_side = mod is jbp
    kw = dict(body_capacity=64, max_pairs=1024, substeps=3, num_colors=4,
              velocity_iterations=2, enable_sleep=True, iteration_schedule=SCHEDULE,
              integrator=(JIntegratorConfig if jax_side else IntegratorConfig)(
                  velocity_callback=JAX_CALLBACK if jax_side else PORT_CALLBACK))
    kw.update(overrides)
    sim = (mod.Simulation(JaxScheduleConfig(**kw)) if jax_side
           else mod.Simulation(mod.SimConfig(**kw), device="cpu"))
    ground = sim.add_shape(mod.Box(20.0, 0.5, 20.0))
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = mod.Sphere(0.5), mod.Box(0.4, 0.4, 0.4)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    rng = np.random.default_rng(11)
    for i in range(24):
        x, z = rng.uniform(-1.2, 1.2, 2)
        desc = (ss, 1.0, s) if i % 2 == 0 else (bs, 1.0, b)
        sim.add_body(mod.BodyDescription.dynamic((x, 0.6 + 0.85 * (i // 8), z), *desc))
    return sim


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry_jax(**overrides):
    """The JAX pile's states after 0 ... FRAMES frames of its own steps, its shapes and
    present types."""
    sim = schedule_pile(jbp, **overrides)
    states = [_np(sim.state)]
    for _ in range(FRAMES):
        sim.timestep(DT)
        states.append(_np(sim.state))
    return dict(states=states, shapes=_np(sim.shapes.device()),
                present=tuple(sorted({int(t) for t in sim.shapes.types if t >= 0})))


def port_config(**overrides):
    return schedule_pile(tbp, **overrides).config


def check_step_from(carried, frame, cfg):
    """One port step from the JAX package's state after ``frame`` frames against the JAX
    package's next state: bodies and the store's impulses within 1e-5, sleep and the
    store's rows exact; the step moved the bodies."""
    before, want = carried["states"][frame], carried["states"][frame + 1]
    state, _ = tsim.step(state_from_numpy(before, "cpu"),
                         shapes_from_numpy(carried["shapes"], "cpu"), {}, DT, cfg,
                         carried["present"])
    got = state_to_numpy(state)
    for f in ("pos", "orn", "vel", "omega"):
        for g, w in zip(getattr(got.bodies, f), getattr(want.bodies, f)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.bodies.awake, want.bodies.awake)
    for f in ("live", "color", "page_color"):
        np.testing.assert_array_equal(getattr(got.store, f), getattr(want.store, f))
    for f in ("imp_pen", "imp_tx", "imp_ty", "imp_tw"):
        np.testing.assert_allclose(getattr(got.store, f), getattr(want.store, f), rtol=0,
                                   atol=1e-5, err_msg=f)
    moved = np.abs(np.stack(want.bodies.pos) - np.stack(before.bodies.pos)).max()
    assert moved > 1e-4


# --- the integrator's callback and the schedule -----------------------------------------

def _body_state(n=40, seed=5):
    """A JAX and a port BodyState of ``n`` bodies from one seeded numpy state: positions
    and velocities at random, a quarter kinematic or asleep."""
    sim = jbp.Simulation(jbp.SimConfig(body_capacity=n, max_pairs=64))
    shape = sim.add_shape(jbp.Sphere(0.5))
    for _ in range(n):
        sim.add_body(jbp.BodyDescription.dynamic((0.0, 0.0, 0.0), shape, 1.0, jbp.Sphere(0.5)))
    st = _np(sim.state)
    rng = np.random.default_rng(seed)
    v3 = lambda scale: type(st.bodies.pos)(*(rng.normal(scale=scale, size=n).astype(np.float32)
                                             for _ in range(3)))
    kind = np.where(rng.random(n) < 0.25, 2, st.bodies.kind).astype(st.bodies.kind.dtype)
    awake = rng.random(n) > 0.25
    st = st._replace(bodies=st.bodies._replace(pos=v3(30.0), vel=v3(5.0), omega=v3(2.0),
                                               kind=kind, awake=awake))
    return (jax.tree_util.tree_map(jnp.asarray, st.bodies),
            state_from_numpy(st, "cpu").bodies, st.bodies)


def test_integrate_velocities_with_a_callback_matches_jax():
    """The callback's result on awake dynamic bodies, the old velocities elsewhere."""
    jstate, tstate, raw = _body_state()
    h = float(np.float32(DT / 3))
    want = jintegrate_velocities(jstate, JIntegratorConfig(velocity_callback=JAX_CALLBACK), h)
    got = integrate_velocities(tstate, IntegratorConfig(velocity_callback=PORT_CALLBACK), h)
    for f in ("vel", "omega"):
        for g, w in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    moving = (raw.kind == 1) & raw.awake
    assert 0 < moving.sum() < len(moving)
    dv = np.stack([g.numpy() for g in got.vel]) - np.stack(raw.vel)
    assert (dv[:, ~moving] == 0).all()
    assert (np.linalg.norm(dv[:, moving], axis=0) > 1e-2).all()  # 10 m/s² over h: 0.056


@pytest.mark.parametrize("schedule", [None, (2, 1, 3), (1, 0, 4, 2), (3,)])
def test_iterations_for_matches_jax(schedule):
    """Per-substep counts as the JAX package gives them, the schedule's entries or
    ``velocity_iterations``; a substep past the end of the schedule raises in both (the
    JAX package does not check the schedule's length up front, so neither does the
    port)."""
    j = JSolveConfig(substeps=3, velocity_iterations=2, iteration_schedule=schedule)
    t = SolveConfig(substeps=3, velocity_iterations=2, iteration_schedule=schedule)
    n = len(schedule) if schedule else 3
    assert [t.iterations_for(s) for s in range(n)] == [j.iterations_for(s) for s in range(n)]
    if schedule is None:
        assert t.iterations_for(7) == j.iterations_for(7) == 2
    else:
        for cfg in (j, t):
            with pytest.raises(IndexError):
                cfg.iterations_for(len(schedule))


# --- the pile against the JAX package's Pallas path ---------------------------------------

@pytest.fixture(scope="module")
def jax_page():
    return carry_jax(solver_backend="pallas")


@pytest.mark.parametrize("frame", range(FRAMES))
def test_schedule_and_callback_step_matches_jax_pallas(jax_page, frame):
    check_step_from(jax_page, frame, port_config(solver_backend="pallas"))


# --- routing, the port alone ----------------------------------------------------------------

def _record(monkeypatch):
    """Record each solve kernel wrapper's calls (name, n_iters) through ``solve.psweep``."""
    calls = []
    for name in ("contact_sweep", "contact_sweep_win", "solve_substeps_contacts",
                 "solve_substeps_contacts_win"):
        fn = getattr(sweep, name)
        monkeypatch.setattr(tsolve.psweep, name, lambda *a, _f=fn, _n=name, **k: calls.append(
            (_n, k.get("n_iters"))) or _f(*a, **k))
    return calls


@pytest.mark.parametrize("setting", ["schedule", "callback", "both"])
@pytest.mark.parametrize("layout", ["page", "windowed"])
def test_either_setting_routes_to_k3_or_k4_never_k1_or_k2(monkeypatch, setting, layout):
    """Two steps of the store-only pile: K3 once per substep with that substep's
    iterations on the page layout, K4 once per iteration on the windowed one; K1 and K2
    never."""
    kw = dict(iteration_schedule=SCHEDULE if setting != "callback" else None)
    if setting == "schedule":
        kw["integrator"] = IntegratorConfig()
    if layout == "windowed":
        kw.update(solver_backend="pallas_win", broadphase="grid2")
    sim = schedule_pile(tbp, **kw)
    calls = _record(monkeypatch)
    sim.run(2, DT)
    iters = list(SCHEDULE) if setting != "callback" else [2, 2, 2]
    if layout == "page":
        assert calls == [("contact_sweep", n) for n in iters] * 2
    else:
        assert calls == [("contact_sweep_win", 1)] * (2 * sum(iters))


def _forced_bucketed(monkeypatch, **kw):
    """The pile's positions and velocities after 6 frames, the whole-solve kernels
    refused (``solve._whole_solve_ok`` False) so that it runs the substep loop."""
    monkeypatch.setattr(tsolve, "_whole_solve_ok", lambda *a: False)
    sim = schedule_pile(tbp, **kw)
    sim.run(6, DT)
    monkeypatch.undo()
    return state_to_numpy(sim.state).bodies


def _default_integration(state, dt):
    """The default gravity and damping (none) written as a callback."""
    g = Vec3(*(torch.full_like(state.vel.x, c) for c in (0.0, -10.0, 0.0)))
    return (state.vel + g * dt) * 1.0, state.omega * 1.0


@pytest.mark.parametrize("layout", ["page", "windowed"])
def test_ones_and_the_default_callback_equal_the_forced_loop(monkeypatch, layout):
    """On the substep loop, a schedule of ones is ``velocity_iterations=1`` and a callback
    computing the default integration is the default integration, bit for bit."""
    win = dict(solver_backend="pallas_win", broadphase="grid2") if layout == "windowed" else {}
    plain = dict(iteration_schedule=None, integrator=IntegratorConfig(), **win)
    forced = _forced_bucketed(monkeypatch, velocity_iterations=1, **plain)
    ones = schedule_pile(tbp, velocity_iterations=1, iteration_schedule=(1, 1, 1),
                         integrator=IntegratorConfig(), **win)
    ones.run(6, DT)
    cb = schedule_pile(tbp, velocity_iterations=1, iteration_schedule=None,
                       integrator=IntegratorConfig(velocity_callback=_default_integration), **win)
    cb.run(6, DT)
    for other in (state_to_numpy(ones.state).bodies, state_to_numpy(cb.state).bodies):
        for f in ("pos", "orn", "vel", "omega"):
            for g, w in zip(getattr(other, f), getattr(forced, f)):
                np.testing.assert_array_equal(g, w, err_msg=f)
    assert (np.abs(np.stack(forced.vel)) > 1e-3).any()
