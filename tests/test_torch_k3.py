"""Kernel K3 (one contact bank's velocity iterations within a substep) in the PyTorch port
against the JAX package's ``ops/sweep.py::contact_sweep``, run in interpret mode on the
CPU. The input is one seeded ``synthetic_sweep_bank`` at the solve's slice size 128: two
colored slices and one Jacobi slice whose sides carry mass-split scales of 2 or more,
padding rows in every slice, and a static body with zero inertia in many rows.

The JAX kernel routes rows through exact bf16x3 one-hot matmuls; the two differ in f32
op order only (the Jacobi sums, XLA's fusion of the row math): 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bepuphysics2_tpu.ops import sweep as jsweep

from bepuphysics2_tpu_torch.ops import sweep

NB, SB, N_COLORED, N_JACOBI = 64, 128, 2, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank():
    return sweep.synthetic_sweep_bank(NB, SB, N_COLORED, N_JACOBI, seed=5, substeps=4)


def _jax_k3(bank, n_iters):
    nch = 128
    table14 = np.zeros((NB, 14), np.float32)
    table14[:, 7:14] = bank["inertia7"]
    vt, imp_t = jsweep.contact_sweep(
        jsweep.pack_state_v(jnp.asarray(bank["v6"]), nch),
        jsweep.pack_state_t(jnp.asarray(table14), nch), jnp.asarray(bank["ps_t"]),
        jnp.asarray(bank["imp_t"]), jnp.asarray(bank["idx2"]), jnp.asarray(bank["scale"]),
        bank["h"], bank["inv_h"], sb=SB, n_iters=n_iters, interpret=True)
    return np.asarray(jsweep.unpack_state_v(vt, NB)), np.asarray(imp_t)


def test_sweep_bank_has_colored_and_jacobi_slices():
    bank = _bank()
    scale = bank["scale"].reshape(N_COLORED + N_JACOBI, 2, SB)
    valid = bank["ps_t"][sweep.PS_VALID].reshape(-1, SB) > 0.5
    assert (scale[N_COLORED:, :, valid[N_COLORED]] >= 2).mean() > 0.5
    assert (scale[:N_COLORED] == 1).all() and valid.any(axis=1).all()
    assert (bank["inertia7"][0] == 0).all() and (bank["inertia7"][1:, 0] > 0).all()


@pytest.mark.parametrize("n_iters", [1, 2])
def test_plain_k3_matches_jax_kernel(n_iters):
    bank = _bank()
    jv6, jimp = _jax_k3(bank, n_iters)
    v6, imp = sweep.contact_sweep(*sweep.sweep_bank_args(bank, "cpu"), sb=SB, n_iters=n_iters)
    np.testing.assert_allclose(v6.numpy(), jv6, rtol=0, atol=1e-5)
    np.testing.assert_allclose(imp.numpy(), jimp, rtol=0, atol=1e-5)
    assert np.abs(jv6 - bank["v6"]).max() > 1e-2  # the sweep moved the bodies


def test_k3_wrapper_checks_its_inputs():
    args = list(sweep.sweep_bank_args(_bank(), "cpu"))
    bad = list(args)
    bad[4] = args[4].long()
    with pytest.raises(TypeError, match="idx2"):
        sweep.contact_sweep(*bad, sb=SB, n_iters=1)
    with pytest.raises(ValueError, match="slices"):
        sweep.contact_sweep(*args, sb=100, n_iters=1)
    before = sweep.contact_sweep.launches
    sweep.contact_sweep(*args, sb=SB, n_iters=1)
    assert sweep.contact_sweep.launches == before  # the CPU runs the plain version
