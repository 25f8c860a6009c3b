"""The port on a CUDA card: kernels K1-K4 and the probe kernels K5-K7 against their plain
PyTorch versions, and whole steps on the card (the K1 path, the windowed K2 path, the general K3
path of the ragdoll tube, the windowed general K4 path of the ragdoll pile and the
contact-only compound pile through K1) against the CPU. Every test needs the card and skips without one; this
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import bepuphysics2_tpu_torch as tbp
import bepuphysics2_tpu_torch.simulation as tsim
from bepuphysics2_tpu_torch.models import (
    build_compound_pile_sim, build_ragdoll_pile_sim, build_ragdoll_tube_sim,
)
from bepuphysics2_tpu_torch.experiments import gather_probe, sweep_proto
from bepuphysics2_tpu_torch.integrator import IntegratorConfig
from bepuphysics2_tpu_torch.ops import probes, sweep

pytestmark = pytest.mark.cuda

SB, SUBSTEPS, ITERS = 128, 2, 2
GRAVITY = (0.0, -10.0, 0.0)
DT = 1 / 60


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _outputs(out):
    v6, pos, orn, imp = out
    return [t.cpu().numpy() for t in (v6, torch.stack(list(pos)), torch.stack(list(orn)), imp)]


@pytest.mark.parametrize("angular_mode", [0, 1, 2])
def test_kernel_matches_plain_on_card(cuda_device, angular_mode):
    """FMA contraction and the kernel's fixed Jacobi summation order differ from
    PyTorch's elementwise ops and ``index_add_``: 1e-4 absolute."""
    bank = sweep.synthetic_bank(64, SB, 2, 1, seed=3, substeps=SUBSTEPS)
    kw = dict(sb=SB, n_substeps=SUBSTEPS, n_iters=ITERS, angular_mode=angular_mode,
              gravity=GRAVITY, waves=torch.from_numpy(bank["waves"]).to(cuda_device))
    before = sweep.solve_substeps_contacts.launches
    got = _outputs(sweep.solve_substeps_contacts(*sweep.bank_args(bank, cuda_device), **kw))
    assert sweep.solve_substeps_contacts.launches == before + 1
    want = _outputs(sweep._solve_substeps_contacts_plain(
        *sweep.bank_args(bank, cuda_device), **{k: v for k, v in kw.items() if k != "waves"}))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    again = _outputs(sweep.solve_substeps_contacts(*sweep.bank_args(bank, cuda_device), **kw))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)  # deterministic run to run


@pytest.mark.parametrize("angular_mode", [0, 1, 2])
def test_k2_matches_plain_on_card(cuda_device, angular_mode):
    """K2 on a windowed bank with narrow, wide, Jacobi and padding rows (2,600 bodies,
    three Morton blocks; color waves of several slices run across the grid): 1e-4
    absolute, as K1; bit-identical run to run."""
    bank = sweep.synthetic_win_bank(2600, 4096, 4, seed=9, substeps=SUBSTEPS, wide_frac=0.05)
    assert bank["wide_rows"] > 0
    kw = dict(sb=bank["sb"], n_substeps=SUBSTEPS, n_iters=ITERS, angular_mode=angular_mode,
              gravity=GRAVITY)
    waves = torch.from_numpy(bank["waves"]).to(cuda_device)
    before = sweep.solve_substeps_contacts_win.launches
    got = _outputs(sweep.solve_substeps_contacts_win(
        *sweep.win_bank_args(bank, cuda_device), **kw, waves=waves))
    assert sweep.solve_substeps_contacts_win.launches == before + 1
    want = _outputs(sweep._solve_substeps_contacts_win_plain(
        *sweep.win_bank_args(bank, cuda_device), **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    again = _outputs(sweep.solve_substeps_contacts_win(
        *sweep.win_bank_args(bank, cuda_device), **kw, waves=waves))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_k3_matches_plain_on_card(cuda_device, n_iters):
    """K3 on a bank of two colored slices and a Jacobi slice with mass-split scales: FMA
    contraction and the kernel's fixed Jacobi summation order differ from PyTorch's
    elementwise ops and ``index_add_``: 1e-4 absolute; bit-identical run to run."""
    bank = sweep.synthetic_sweep_bank(64, SB, 2, 1, seed=5, substeps=4)
    kw = dict(sb=SB, n_iters=n_iters)
    waves = torch.from_numpy(bank["waves"]).to(cuda_device)
    args = sweep.sweep_bank_args(bank, cuda_device)
    before = sweep.contact_sweep.launches
    got = [t.cpu().numpy() for t in sweep.contact_sweep(*args, **kw, waves=waves)]
    assert sweep.contact_sweep.launches == before + 1
    want = [t.cpu().numpy() for t in sweep._contact_sweep_plain(*args, **kw)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    again = [t.cpu().numpy() for t in sweep.contact_sweep(*args, **kw, waves=waves)]
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_k4_matches_plain_on_card(cuda_device, n_iters):
    """K4 on a windowed bank with narrow, wide, Jacobi and padding rows and dead slices
    (2,600 bodies, three Morton blocks; color waves of several slices run across the
    grid): FMA contraction and the kernel's fixed summation
    order differ from PyTorch's elementwise ops and ``index_add_``: 1e-4 absolute;
    bit-identical run to run."""
    bank = sweep.synthetic_win_bank(2600, 4096, 4, seed=9, substeps=4, wide_frac=0.05)
    kw = dict(sb=bank["sb"], n_iters=n_iters)
    args = sweep.sweep_win_bank_args(bank, cuda_device)
    waves = torch.from_numpy(bank["waves"]).to(cuda_device)
    before = sweep.contact_sweep_win.launches
    got = [t.cpu().numpy() for t in sweep.contact_sweep_win(*args, **kw, waves=waves)]
    assert sweep.contact_sweep_win.launches == before + 1
    want = [t.cpu().numpy() for t in sweep._contact_sweep_win_plain(*args, **kw)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert np.abs(got[0] - bank["v6"]).max() > 1e-2
    again = [t.cpu().numpy() for t in sweep.contact_sweep_win(*args, **kw, waves=waves)]
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


def _card_steps_hold_cpu(cpu, card, frames, tol=1e-4):
    """Step ``cpu`` ``frames`` times; each frame, step the card from the CPU's state before
    it and hold the result to the CPU's within ``tol`` (absolute and relative)."""
    from bepuphysics2_tpu_torch.interop import state_from_numpy, state_to_numpy

    dev = card.device
    shapes, banks = card.shapes.device(dev), card._joint_banks()
    for _ in range(frames):
        before = state_to_numpy(cpu.state)
        cpu.timestep(DT)
        got, _ = tsim.step(state_from_numpy(before, dev), shapes, banks, DT, cpu.config,
                           card._present_types())
        for f in ("pos", "orn", "vel", "omega"):
            for g, w in zip(getattr(got.bodies, f), getattr(cpu.state.bodies, f)):
                np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=tol, atol=tol)


def _launches():
    return (sweep.solve_substeps_contacts.launches, sweep.solve_substeps_contacts_win.launches,
            sweep.contact_sweep.launches, sweep.contact_sweep_win.launches)


def test_ragdoll_pile_on_card_matches_cpu_and_repeats(cuda_device):
    """The 4-ragdoll pile on the windowed general path (grid2, K4): every card step from
    the CPU's state within 1e-4 of the CPU's, 10 frames; K4 launches substeps x
    iterations times per step and K1, K2 and K3 never; two card runs bit-identical."""
    kw = dict(substeps=2, num_colors=4, layer=(2, 1), solver_backend="pallas_win",
              broadphase="grid2")
    cpu, _ = build_ragdoll_pile_sim(4, device="cpu", **kw)
    card, _ = build_ragdoll_pile_sim(4, device=cuda_device, **kw)
    _card_steps_hold_cpu(cpu, card, 10)
    runs = []
    for _ in range(2):
        sim, _ = build_ragdoll_pile_sim(4, device=cuda_device, **kw)
        k1, k2, k3, k4 = _launches()
        sim.run(20, DT)
        assert _launches() == (k1, k2, k3, k4 + 20 * 2)
        runs.append((_positions(sim), sim.state_hash()))
    (card1, h1), (card2, h2) = runs
    assert h1 == h2
    np.testing.assert_array_equal(card1, card2)


def test_compound_pile_on_card_matches_cpu(cuda_device):
    """The contact-only compound pile: every card step from the CPU's state within 1e-4 of
    the CPU's, 10 frames; K1 launches once per step, K2, K3 and K4 never."""
    cpu, _ = build_compound_pile_sim(18, substeps=2, num_colors=4, device="cpu")
    card, _ = build_compound_pile_sim(18, substeps=2, num_colors=4, device=cuda_device)
    _card_steps_hold_cpu(cpu, card, 10)
    k1, k2, k3, k4 = _launches()
    card.run(10, DT)
    assert _launches() == (k1 + 10, k2, k3, k4)
    assert int(card.last_diag.contact_count) > 0


def _pile(device, **cfg):
    sim = tbp.Simulation(tbp.SimConfig(body_capacity=64, max_pairs=256, substeps=2,
                                       num_colors=4, velocity_iterations=2, **cfg),
                         device=device)
    ground = sim.add_shape(tbp.Box(20.0, 0.5, 20.0))
    sim.add_static(tbp.StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = tbp.Sphere(0.5), tbp.Box(0.4, 0.4, 0.4)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    rng = np.random.default_rng(11)
    for i in range(24):
        x, z = rng.uniform(-1.2, 1.2, 2)
        desc = (ss, 1.0, s) if i % 2 == 0 else (bs, 1.0, b)
        sim.add_body(tbp.BodyDescription.dynamic((x, 0.6 + 0.85 * (i // 8), z), *desc))
    return sim


def _positions(sim):
    sim._sync_from_device()
    return np.stack([sim._host.px, sim._host.py, sim._host.pz])


def test_pile_on_card_matches_cpu_and_repeats(cuda_device):
    """20 frames on the card and on the CPU, within the JAX package's own envelope for
    two solve paths (5e-3 max, 1e-4 median); two card runs are bit-identical."""
    runs = []
    for dev in (cuda_device, cuda_device, "cpu"):
        sim = _pile(dev)
        before = sweep.solve_substeps_contacts.launches
        sim.run(20, DT)
        if dev != "cpu":
            assert sweep.solve_substeps_contacts.launches == before + 20
        runs.append((_positions(sim), sim.state_hash()))
    (card, h1), (card2, h2), (cpu, _) = runs
    assert h1 == h2
    np.testing.assert_array_equal(card, card2)
    diff = np.abs(card - cpu)
    assert diff.max() < 5e-3 and np.median(diff) < 1e-4


def test_windowed_pile_on_card_matches_cpu_and_repeats(cuda_device):
    """The windowed path (grid2, K2) for 20 frames on the card and on the CPU, within the
    JAX package's envelope for its windowed kernel (2e-2 max, 1e-3 median); K2 launches
    once per step and K1 not at all; two card runs are bit-identical."""
    runs = []
    for dev in (cuda_device, cuda_device, "cpu"):
        sim = _pile(dev, solver_backend="pallas_win", broadphase="grid2")
        k1, k2 = sweep.solve_substeps_contacts.launches, sweep.solve_substeps_contacts_win.launches
        sim.run(20, DT)
        if dev != "cpu":
            assert sweep.solve_substeps_contacts_win.launches == k2 + 20
            assert sweep.solve_substeps_contacts.launches == k1
        runs.append((_positions(sim), sim.state_hash()))
    (card, h1), (card2, h2), (cpu, _) = runs
    assert h1 == h2
    np.testing.assert_array_equal(card, card2)
    diff = np.abs(card - cpu)
    assert diff.max() < 2e-2 and np.median(diff) < 1e-3


def test_ragdoll_tube_on_card_matches_cpu_and_repeats(cuda_device):
    """The 2-ragdoll tube (joints and the tube's compound bank: the general path): every
    card step from the CPU's state lands on the CPU's next state within 1e-4 (absolute and
    relative: K3's limit), 20 frames; K3 launches for both contact banks in every substep
    and K1 and K2 never; two 20-frame card runs are bit-identical. (The trajectories
    themselves are chaotic from frame 3, in the JAX package's own two paths alike.)"""
    from bepuphysics2_tpu_torch.interop import state_from_numpy, state_to_numpy

    cpu, _ = build_ragdoll_tube_sim(2, substeps=2, num_colors=4, device="cpu")
    card, _ = build_ragdoll_tube_sim(2, substeps=2, num_colors=4, device=cuda_device)
    shapes, banks = card.shapes.device(cuda_device), card._joint_banks()
    for _ in range(20):
        before = state_to_numpy(cpu.state)
        cpu.timestep(DT)
        got, _ = tsim.step(state_from_numpy(before, cuda_device), shapes, banks, DT, cpu.config,
                           card._present_types())
        for f in ("pos", "orn", "vel", "omega"):
            for g, w in zip(getattr(got.bodies, f), getattr(cpu.state.bodies, f)):
                np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=1e-4)
    runs = []
    for _ in range(2):
        sim, _ = build_ragdoll_tube_sim(2, substeps=2, num_colors=4, device=cuda_device)
        k1, k2 = sweep.solve_substeps_contacts.launches, sweep.solve_substeps_contacts_win.launches
        k3 = sweep.contact_sweep.launches
        sim.run(20, DT)
        assert sweep.contact_sweep.launches == k3 + 20 * 2 * 2
        assert (sweep.solve_substeps_contacts.launches,
                sweep.solve_substeps_contacts_win.launches) == (k1, k2)
        runs.append((_positions(sim), sim.state_hash()))
    (card1, h1), (card2, h2) = runs
    assert h1 == h2
    np.testing.assert_array_equal(card1, card2)


@pytest.mark.parametrize("duplicates", [False, True], ids=["permutation", "duplicates"])
@pytest.mark.parametrize("variant", [v[0] for v in sweep_proto.VARIANTS])
def test_k5_matches_plain_on_card(cuda_device, variant, duplicates):
    """K5 on the sweep prototypes' inputs in each variant's layout and mode: it rounds
    every operation as the plain version does, so a pass without repeated indices gives
    its bits; ``index_add_`` on the card sums repeated targets with atomics, in any order,
    and mode D's state grows to |x| ~ 70: 1e-5, absolute and relative. Bit-identical run
    to run; the state moved (mode C: within 1e-6 of its input)."""
    _, fn, lanes, transposed, mode = next(v for v in sweep_proto.VARIANTS if v[0] == variant)
    v6, idx = sweep_proto.inputs_with_duplicates() if duplicates else sweep_proto.inputs()
    state = probes.to_state(torch.from_numpy(v6), lanes, transposed).to(cuda_device)
    idx = torch.from_numpy(idx).to(cuda_device)
    before = probes.probe_sweep.launches
    got = fn(state, idx)
    assert probes.probe_sweep.launches == before + 1
    want = probes._probe_sweep_plain(state, idx, lanes, transposed, mode)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    if not duplicates:
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(fn(state, idx).cpu().numpy(), got.cpu().numpy())
    moved = float((got - state).abs().max())
    assert moved <= 1e-6 if mode == "C" else moved > 1e-1


@pytest.mark.parametrize("label", ["k1", "k2", "k3", "k4", "k5", "k6"])
def test_k6_k7_equal_plain_on_card(cuda_device, label):
    """The gather probes through K6 and the scatter probe through K7, on the probe's own
    inputs and on distinct ``d`` rows: exactly the plain version, and again on a repeat."""
    v, idx, d = gather_probe.inputs(cuda_device)
    if label == "k5":
        d = torch.from_numpy(np.random.default_rng(3).normal(size=tuple(d.shape))
                             .astype(np.float32)).to(cuda_device)
        args, plain, counter = (v, idx, d), probes._probe_scatter_plain, probes.probe_scatter
    else:
        args, plain, counter = (v, idx), probes._probe_gather_plain, probes.probe_gather
    fn = getattr(gather_probe, label)
    before = counter.launches
    got = fn(*args)
    assert counter.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), plain(*args).cpu().numpy())
    np.testing.assert_array_equal(fn(*args).cpu().numpy(), got.cpu().numpy())


@pytest.mark.parametrize("width", [8, 6, 3])
def test_k6_equals_plain_at_each_width(cuda_device, width):
    """K6 copies 16-byte vectors where the width is a multiple of 4 (an (NB, 8) row is
    two float4) and one element per thread otherwise: exactly the plain gather at W = 8,
    6 and 3, on distinct values."""
    rng = np.random.default_rng(width)
    v = torch.from_numpy(rng.normal(size=(1000, width)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 1000, 777).astype(np.int32)).to(cuda_device)
    before = probes.probe_gather.launches
    got = probes.probe_gather(v, idx)
    assert probes.probe_gather.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), probes._probe_gather_plain(v, idx).cpu().numpy())


@pytest.mark.parametrize("case", [c[0] for c in gather_probe.scatter_cases()])
def test_k7_equals_plain_bit_for_bit_on_card(cuda_device, case):
    """K7 on its edge cases (``gather_probe.scatter_cases``: distinct ``d`` rows, one
    target, indices outside [0, NB), M > NB, -0.0 rows, rows of 6 floats): the plain
    version's bits, in one launch and no sort, and the same bits on a repeat."""
    _, v, idx, d = next(c for c in gather_probe.scatter_cases(cuda_device) if c[0] == case)
    bits = lambda t: t.cpu().view(torch.int32)
    sort = torch.sort
    torch.sort = None  # K7 sorts nothing: a call of torch.sort would fail here
    try:
        before = probes.probe_scatter.launches
        got = probes.probe_scatter(v, idx, d)
        assert probes.probe_scatter.launches == before + 1
        again = probes.probe_scatter(v, idx, d)
    finally:
        torch.sort = sort
    assert torch.equal(bits(got), bits(probes._probe_scatter_plain(v, idx, d)))
    assert torch.equal(bits(again), bits(got))


def _radial_gravity(state, dt):
    """Gravity of 10 toward a point 1,000 m below the ground and a damping of 0.05/s."""
    from bepuphysics2_tpu_torch.utils.vec import Vec3

    rx, ry, rz = -state.pos.x, -1000.5 - state.pos.y, -state.pos.z
    k = 10.0 / torch.sqrt(rx * rx + ry * ry + rz * rz)
    return (state.vel + Vec3(rx * k, ry * k, rz * k) * dt) * 0.95 ** dt, state.omega


@pytest.mark.parametrize("layout", ["page", "windowed"])
def test_scheduled_pile_on_card_matches_cpu_and_repeats(cuda_device, layout):
    """The iteration schedule (2, 1) and a velocity callback take the pile off K1 and K2:
    K3 once per substep (page layout, the store a lone bank) or K4 once per iteration
    (windowed), K1 and K2 never; 20 frames within the envelope of that layout (5e-3 / 1e-4,
    windowed 2e-2 / 1e-3) of the CPU's; two card runs are bit-identical."""
    win = dict(solver_backend="pallas_win", broadphase="grid2") if layout == "windowed" else {}
    kernel, per_step = ((sweep.contact_sweep_win, 3) if win else (sweep.contact_sweep, 2))
    runs = []
    for dev in (cuda_device, cuda_device, "cpu"):
        sim = _pile(dev, iteration_schedule=(2, 1), integrator=IntegratorConfig(
            velocity_callback=_radial_gravity), **win)
        before = dict(k=kernel.launches, k1=sweep.solve_substeps_contacts.launches,
                      k2=sweep.solve_substeps_contacts_win.launches)
        sim.run(20, DT)
        if dev != "cpu":
            assert kernel.launches == before["k"] + per_step * 20
            assert sweep.solve_substeps_contacts.launches == before["k1"]
            assert sweep.solve_substeps_contacts_win.launches == before["k2"]
        runs.append((_positions(sim), sim.state_hash()))
    (card, h1), (card2, h2), (cpu, _) = runs
    assert h1 == h2
    np.testing.assert_array_equal(card, card2)
    diff = np.abs(card - cpu)
    tol = (2e-2, 1e-3) if win else (5e-3, 1e-4)
    assert diff.max() < tol[0] and np.median(diff) < tol[1]
