"""Queue 1 item 21's utilities through the port, held to the JAX package on the CPU.

- ``save_checkpoint`` / ``load_checkpoint`` (``checkpoint.py``): steps after a restore
  give the bits of the same steps after the save; a checkpoint of other capacities raises
  the JAX package's shape-mismatch error.
- ``compute_metrics`` (``metrics.py``) on the port's state and the JAX package's on the
  same state carried into it, within 1e-5 (relative and absolute: the sums reduce in
  another order), on ``tests/test_metrics.py``'s free-fall ball (30 steps) and resting
  pile (150 steps, asleep), and on that pile with every body's velocity and spin drawn
  from a seed; the JAX test's own gates on the port's numbers.
- ``validate`` (``validation.py``) passes on a sound scene and raises what the JAX package
  raises, message for message, on each corruption both check: a NaN, an unnormalized
  quaternion, a sleeping body that moves, a static with inverse mass, a joint on an empty
  body; and on a store record of an empty body (the port checks the pair store, where the
  JAX package checks its legacy cache, which the store path leaves empty).
- ``profile_stages`` (``profiling.py``): the JAX package's keys, each a positive time.
- ``TraceSession`` writes a non-empty trace.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bepuphysics2_tpu as jbp
from bepuphysics2_tpu import metrics as jmetrics
from bepuphysics2_tpu import validation as jvalidation

import bepuphysics2_tpu_torch as tbp
from bepuphysics2_tpu_torch import metrics, profiling, validation
from bepuphysics2_tpu_torch.interop import state_to_numpy

DT = 1 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def free_fall(mod):
    sim = (mod.Simulation(mod.SimConfig(body_capacity=16, max_pairs=16, substeps=4,
                                        num_colors=4), device="cpu") if mod is tbp
           else mod.Simulation(mod.SimConfig(body_capacity=16, max_pairs=16, substeps=4,
                                             num_colors=4)))
    s = mod.Sphere(0.5)
    sim.add_body(mod.BodyDescription.dynamic((0.0, 100.0, 0.0), sim.add_shape(s), 2.0, s))
    return sim


def resting_pile(mod):
    cfg = dict(body_capacity=16, max_pairs=64, substeps=4, num_colors=4, sleep_time=0.3)
    sim = (mod.Simulation(mod.SimConfig(**cfg), device="cpu") if mod is tbp
           else mod.Simulation(mod.SimConfig(**cfg)))
    g = sim.add_shape(mod.Box(20.0, 0.5, 20.0))
    s = mod.Sphere(0.5)
    ss = sim.add_shape(s)
    sim.add_static(mod.StaticDescription(position=(0, -0.5, 0), shape=g))
    for i in range(3):
        sim.add_body(mod.BodyDescription.dynamic((i * 1.5, 0.5, 0.0), ss, 1.0, s))
    return sim


def _carry(template, tree):
    """The JAX package's ``template`` tree with the port's same-named leaves."""
    if isinstance(template, dict):
        return {k: _carry(template[k], tree[k]) for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*(_carry(getattr(template, f), getattr(tree, f))
                                if hasattr(tree, f) else getattr(template, f)
                                for f in template._fields))
    return jnp.asarray(np.asarray(tree))


def carried(jsim, tsim):
    """The JAX simulation with the port simulation's state."""
    jsim._state = _carry(jsim.state, state_to_numpy(tsim.state))
    jsim._dirty = False
    return jsim


@pytest.fixture(scope="module")
def stepped():
    """The two scenes stepped in the port (30 and 150 steps), each beside its JAX twin."""
    ff, pile = free_fall(tbp), resting_pile(tbp)
    m0 = metrics.simulation_metrics(ff)
    ff.run(30, DT)
    pile.run(150, DT)
    return dict(ff=(ff, free_fall(jbp), m0), pile=(pile, resting_pile(jbp)))


def _spun(sim):
    """The pile with every dynamic body's velocity and spin drawn from a seed, awake."""
    rng = np.random.default_rng(0)
    for h in range(1, 4):
        sim.set_velocity(h, linear=tuple(rng.normal(size=3)),
                         angular=tuple(rng.normal(size=3)))
    return sim


@pytest.mark.parametrize("scene", ["free_fall", "resting_pile", "spun_pile"])
def test_compute_metrics_matches_jax(stepped, scene):
    tsim, jsim = stepped["ff" if scene == "free_fall" else "pile"][:2]
    if scene == "spun_pile":
        tsim = _spun(tsim)
    got = metrics.simulation_metrics(tsim)
    jsim = carried(jsim, tsim)
    want = jmetrics.compute_metrics(jsim.state, jsim.shapes.device(), jsim.config)
    for f in metrics.SimMetrics._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    if scene == "free_fall":  # tests/test_metrics.py's gates
        m0 = stepped["ff"][2]
        e0 = float(m0.kinetic_energy) + float(m0.potential_energy)
        e1 = float(got.kinetic_energy) + float(got.potential_energy)
        assert abs(e1 - e0) < 0.01 * max(abs(e0), 1.0), (e0, e1)
        assert float(got.max_speed) > 4.0
        assert int(got.awake_dynamic_count) == 1 and int(got.contact_count) == 0
    elif scene == "resting_pile":
        assert int(got.sleeping_count) == 3 and int(got.awake_dynamic_count) == 0
        assert float(got.kinetic_energy) < 1e-4
        assert float(got.contact_impulse_total) > 0.0
        assert 0.0 < float(got.pair_utilization) <= 1.0
    else:
        assert float(got.kinetic_energy) > 1.0
        assert np.abs(np.asarray(got.angular_momentum_origin)).max() > 0.1


def test_checkpoint_round_trip_gives_the_same_bits():
    sim = resting_pile(tbp)
    sim.run(5, DT)
    data = sim.save_checkpoint()
    sim.run(5, DT)
    after = sim.state_hash()
    sim.load_checkpoint(data)
    sim.run(5, DT)
    assert sim.state_hash() == after
    # The host columns follow the restored state.
    np.testing.assert_array_equal(sim.get_body(1)[0],
                                  [float(c[1]) for c in sim.state.bodies.pos])


def test_checkpoint_of_other_capacities_raises_the_jax_error():
    data = free_fall(tbp).save_checkpoint()
    big = tbp.Simulation(tbp.SimConfig(body_capacity=32, max_pairs=16, substeps=4,
                                       num_colors=4), device="cpu")
    with pytest.raises(ValueError, match="checkpoint shape mismatch") as got:
        big.load_checkpoint(data)
    jdata = free_fall(jbp).save_checkpoint()
    jbig = jbp.Simulation(jbp.SimConfig(body_capacity=32, max_pairs=16, substeps=4,
                                        num_colors=4))
    with pytest.raises(ValueError, match="checkpoint shape mismatch") as want:
        jbig.load_checkpoint(jdata)
    assert str(got.value) == str(want.value)


def _jointed(mod):
    sim = resting_pile(mod)
    sim.add_constraint("ball_socket", [1, 2], local_offset_a=(0.75, 0.0, 0.0),
                       local_offset_b=(-0.75, 0.0, 0.0))
    return sim


def _corrupt(state, case):
    """The port state with one corruption (numpy in, numpy out)."""
    b = state.bodies
    if case == "nan":
        b.pos.x[2] = np.nan
    elif case == "quaternion":
        b.orn.w[1] = 2.0
    elif case == "sleeping_moves":
        b.awake[3] = False
        b.vel.y[3] = 0.5
    elif case == "static_mass":
        b.inv_mass[0] = 1.0
    return state


@pytest.mark.parametrize("case", ["sound", "nan", "quaternion", "sleeping_moves",
                                  "static_mass", "joint_on_empty_body"])
def test_validate_matches_jax(case):
    from bepuphysics2_tpu_torch.interop import state_from_numpy

    tsim, jsim = _jointed(tbp), _jointed(jbp)
    tsim.run(2, DT)
    snap = _corrupt(state_to_numpy(tsim.state), case)
    tsim._state = state_from_numpy(snap, "cpu")
    if case == "joint_on_empty_body":
        for s in (tsim, jsim):
            s.joints["ball_socket"].bodies[0, 1] = 9  # slot 9 holds no body
    jsim = carried(jsim, tsim)
    outcomes = []
    for fn, sim in ((validation.validate, tsim), (jvalidation.validate, jsim)):
        try:
            fn(sim)
            outcomes.append(None)
        except AssertionError as e:  # ValidationError, in either package
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case == "sound")


def test_validate_checks_the_store_records():
    sim = resting_pile(tbp)
    sim.run(2, DT)
    snap = state_to_numpy(sim.state)
    row = int(np.nonzero(snap.store.live)[0][0])
    snap.store.body_b[row] = 9  # slot 9 holds no body
    from bepuphysics2_tpu_torch.interop import state_from_numpy

    sim._state = state_from_numpy(snap, "cpu")
    with pytest.raises(validation.ValidationError, match="contact cache references removed body"):
        validation.validate(sim)


def test_profile_stages_keys_and_trace(tmp_path):
    sim = resting_pile(tbp)
    sim.run(3, DT)
    stages = profiling.profile_stages(sim, DT, iters=2)
    assert list(stages) == ["bounds", "broadphase", "narrowphase", "solve"]
    assert all(v > 0.0 for v in stages.values())
    with metrics.TraceSession(str(tmp_path)) as trace:
        sim.run(2, DT)
    assert trace.path is not None and (tmp_path / trace.path.split("/")[-1]).stat().st_size > 0
