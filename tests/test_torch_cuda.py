"""The port on a CUDA card: kernel K1 against its plain PyTorch version, and whole steps
on the card against the CPU. Every test needs the card and skips without one; this file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import bepuphysics2_tpu_torch as tbp
from bepuphysics2_tpu_torch.ops import sweep

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
              gravity=GRAVITY)
    before = sweep.solve_substeps_contacts.launches
    got = _outputs(sweep.solve_substeps_contacts(*sweep.bank_args(bank, cuda_device), **kw))
    assert sweep.solve_substeps_contacts.launches == before + 1
    want = _outputs(sweep._solve_substeps_contacts_plain(
        *sweep.bank_args(bank, cuda_device), **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    again = _outputs(sweep.solve_substeps_contacts(*sweep.bank_args(bank, cuda_device), **kw))
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)  # deterministic run to run


def _pile(device):
    sim = tbp.Simulation(tbp.SimConfig(body_capacity=64, max_pairs=256, substeps=2,
                                       num_colors=4, velocity_iterations=2), device=device)
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
