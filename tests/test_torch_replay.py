"""The general path's joint sweep and the generic narrow phase through
``utils/replay.py``.

- On the CPU ``replay.run`` calls the function as it is; the fixed-order sum the sweep
  rebuilds from its tensors (``FixedOrderSum.of``) adds as the one it came from, bit for
  bit.
- On the card (``cuda``) both replay as CUDA graphs from their second call on: the 30-rig
  battery, a two-ragdoll tube and a 40-body five-shape pile give, step by step, the bits
  of the same steps run eagerly (``replay.enabled`` off). So does a single ray with
  ``exclude`` (the whole cast replays), on a 64-body pile on a mesh, called three times
  (eager, captured, replayed). A batch of capsule sweeps on that pile runs its
  conservative advancement in kernel K8 and replays nothing: its three calls give the
  bits of the same calls through K8's plain version (``sweeps._advance``), run eagerly.
"""
import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch.solver import buckets as bk_mod
from bepuphysics2_tpu_torch.utils import replay


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one torch thread runs them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_fixed_order_sum_rebuilt_from_its_tensors_adds_the_same_bits(n):
    rng = np.random.default_rng(n)
    n_rows = 12
    tgt = torch.from_numpy(rng.integers(0, n_rows + 1, n))  # n_rows is the sink
    vals = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(n_rows, 6)).astype(np.float32))
    s = bk_mod.FixedOrderSum(tgt, n_rows)
    again = bk_mod.FixedOrderSum.of(s.tensors(), n_rows)
    torch.testing.assert_close(again.add(dst, vals), s.add(dst, vals), rtol=0, atol=0)


def test_replay_runs_the_function_as_it_is_on_the_cpu():
    calls = []

    def fn(d):
        calls.append(1)
        return d["a"] * 2.0, d["b"][0] + d["b"][1]

    inputs = dict(a=torch.arange(4.0), b=[torch.ones(3), torch.full((3,), 2.0)])
    for _ in range(3):
        a, b = replay.run(("test", 1), fn, inputs)
        torch.testing.assert_close(a, torch.arange(4.0) * 2.0, rtol=0, atol=0)
        torch.testing.assert_close(b, torch.full((3,), 3.0), rtol=0, atol=0)
    assert len(calls) == 3 and not replay._GRAPHS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _hashes(build, device, steps, enabled):
    replay.clear()
    replay.enabled = enabled
    try:
        sim = build(device)
        out = []
        for _ in range(steps):
            sim.run(1, 1 / 60)
            out.append(sim.state_hash())
        return out
    finally:
        replay.enabled = True
        replay.clear()


def _five_shape_pile(device, n=40):
    """``n`` bodies taking in turn a sphere, a capsule, a box, a cylinder and a 24-point
    hull, in a column grid from 0.6 m up over a static box ground."""
    import bepuphysics2_tpu_torch as tbp

    sim = tbp.Simulation(tbp.SimConfig(body_capacity=64, max_pairs=1024, substeps=2,
                                       num_colors=4), device=device)
    ground = sim.add_shape(tbp.Box(20.0, 0.5, 20.0))
    sim.add_static(tbp.StaticDescription(position=(0, -0.5, 0), shape=ground))
    pts = np.random.default_rng(7).normal(size=(24, 3))
    pts *= 0.5 / np.linalg.norm(pts, axis=1, keepdims=True)
    objs = (tbp.Sphere(0.5), tbp.Capsule(0.3, 0.4), tbp.Box(0.5, 0.5, 0.5),
            tbp.Cylinder(0.5, 0.4), tbp.ConvexHull.from_points(pts))
    ids = [sim.add_shape(o) for o in objs]
    for k in range(n):
        p = ((k % 4) * 1.2 - 1.8, 0.6 + (k // 16) * 1.2, ((k // 4) % 4) * 1.2 - 1.8)
        sim.add_body(tbp.BodyDescription.dynamic(p, ids[k % 5], 1.0, objs[k % 5]))
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["rigs", "tube", "five_shape_pile"])
def test_replayed_steps_give_the_eager_bits(scene, cuda_device):
    from bepuphysics2_tpu_torch.models import build_ragdoll_tube_sim
    from bepuphysics2_tpu_torch.models.joint_rigs import build_joint_rigs

    build = {"rigs": lambda d: build_joint_rigs(d, steps=0).sim,
             "tube": lambda d: build_ragdoll_tube_sim(2, substeps=2, num_colors=4,
                                                      device=d)[0],
             "five_shape_pile": _five_shape_pile}[scene]
    assert _hashes(build, cuda_device, 8, True) == _hashes(build, cuda_device, 8, False)


def _query_results(query, device, enabled):
    """Three calls of ``query`` on a settled 64-body mesh-terrain pile, as numpy. Not
    ``enabled``: every call eager, and the sweeps' advancement through K8's plain
    version instead of K8."""
    from bepuphysics2_tpu_torch.collision import sweeps
    from bepuphysics2_tpu_torch.models import build_terrain_pile_sim

    replay.clear()
    replay.enabled = enabled
    kernel = sweeps.conservative_advance
    if not enabled:
        sweeps.conservative_advance = lambda x, iters, miss: sweeps._advance(x, (), iters, miss)
    try:
        sim, _ = build_terrain_pile_sim(64, 10, device=device)
        sim.run(20, 1 / 60)
        out = []
        for k in range(3):
            res = query(sim, k)
            out.append([np.asarray(torch.stack(list(v)).cpu() if isinstance(v, tuple)
                                   else v.cpu()) for v in res if v is not None])
        return out
    finally:
        sweeps.conservative_advance = kernel
        replay.enabled = True
        replay.clear()


def _sweeps(sim, k):
    import bepuphysics2_tpu_torch as tbp

    rng = np.random.default_rng(k)
    p = np.concatenate([rng.uniform(-8, 8, (16, 1)), np.full((16, 1), 4.0),
                        rng.uniform(-8, 8, (16, 1))], 1)
    v = np.tile([0.0, -2.0, 0.0], (16, 1))
    return sim.sweep_shape_batch(tbp.Capsule(0.3, 0.4), p, v, max_t=3.0,
                                 angular_velocities=rng.normal(scale=0.5, size=(16, 3)))


def _ray(sim, k):
    return sim.ray_cast((k - 1.0, 5.0, 0.5), (0.0, -1.0, 0.0), 10.0, exclude=1 + k)


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["sweep_shape_batch", "ray_cast"])
def test_replayed_queries_give_the_eager_bits(query, cuda_device):
    from bepuphysics2_tpu_torch.collision import sweeps

    fn = {"sweep_shape_batch": _sweeps, "ray_cast": _ray}[query]
    before = sweeps.conservative_advance.launches
    got = _query_results(fn, cuda_device, True)
    if query == "sweep_shape_batch":
        assert sweeps.conservative_advance.launches == before + 3  # K8 once a call
    want = _query_results(fn, cuda_device, False)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert any(bool(r[0].any()) for r in want)  # something was hit
