"""Kernel K4 (one windowed contact bank's velocity iterations within a substep) in the
PyTorch port against the JAX package's ``ops/sweep.py::contact_sweep_win``, run in
interpret mode on the CPU. The input is one seeded ``synthetic_win_bank`` of 2,600 bodies
(three Morton blocks, so narrow slices reach four distinct window segments), 4,096 rows
with 5% joining far bodies (wide slices), 4 colors plus the Jacobi color whose sides
carry mass-split scales, padding rows in partly filled slices and dead slices.

The JAX kernel routes rows through exact bf16x3 one-hot matmuls; the two differ in f32
op order only (the per-body sums, XLA's fusion of the row math): 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bepuphysics2_tpu.ops import sweep as jsweep

from bepuphysics2_tpu_torch.ops import sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bank():
    return sweep.synthetic_win_bank(2600, 4096, 4, seed=9, substeps=4, wide_frac=0.05)


def _args(bank):
    """K4's arguments, with nonzero impulses planted on the padding rows: JAX runs every
    live slice, and a padding row must keep what it holds."""
    args = list(sweep.sweep_win_bank_args(bank, "cpu"))
    pad = args[2][sweep.PS_VALID] < 0.5
    rng = np.random.default_rng(1)
    planted = torch.from_numpy(rng.uniform(0.0, 0.02, (7, int(pad.sum()))))
    args[3][:7, pad] = planted.float()  # row 7 is the contract's zero pad row
    return args


def _jax_k4(bank, args, n_iters):
    v6p, it_t, ps_t, imp_t, whi2, wlo2, scale, wseg, inv_h = args
    np_, nch = v6p.shape[0], v6p.shape[0] // sweep.L
    a = lambda t: jnp.asarray(t.numpy())
    vt, imp = jsweep.contact_sweep_win(
        jsweep.pack_state_v(a(v6p), nch), a(it_t), a(ps_t), a(imp_t), a(whi2), a(wlo2),
        a(scale), a(wseg), bank["h"], inv_h, sb=bank["sb"], n_iters=n_iters, interpret=True)
    return np.asarray(jsweep.unpack_state_v(vt, np_)), np.asarray(imp)


def test_win_bank_has_the_cases_k4_must_cover(bank):
    wseg = bank["wseg"]
    live = wseg[:, 0] >= 0
    assert (~live).any()  # dead slices
    assert any(len(set(row)) == 4 for row in wseg[live].tolist())  # four distinct segments
    assert bank["wide_rows"] > 0
    valid = bank["ps_t"][sweep.PS_VALID] > 0.5
    sb = bank["sb"]
    assert (~valid.reshape(-1, sb)[live]).any()  # padding rows in live slices
    scale = bank["scale"].reshape(-1, 2, sb)
    assert (scale[np.broadcast_to(valid.reshape(-1, 1, sb), scale.shape)] > 1).any()
    # The streamed inertia is the side's body inertia times its scale.
    pos = sweep.window_positions(*(torch.from_numpy(bank[k]) for k in ("whi2", "wlo2", "wseg")),
                                 sb).numpy()
    it7 = sweep._inertia7_np(bank)
    first = np.nonzero(valid)[0][0]
    sl, r = divmod(first, sb)
    np.testing.assert_allclose(bank["it_t"][8:15, first],
                               it7[pos[sl, sb + r]] * bank["scale"][sl * 2 * sb + sb + r],
                               rtol=1e-6)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_plain_k4_matches_jax_kernel(bank, n_iters):
    args = _args(bank)
    jv6, jimp = _jax_k4(bank, args, n_iters)
    v6, imp = sweep.contact_sweep_win(*args, sb=bank["sb"], n_iters=n_iters)
    np.testing.assert_allclose(v6.numpy(), jv6, rtol=0, atol=1e-5)
    np.testing.assert_allclose(imp.numpy(), jimp, rtol=0, atol=1e-5)
    assert np.abs(jv6 - bank["v6"]).max() > 1e-2  # the sweep moved the bodies
    pad = args[2][sweep.PS_VALID] < 0.5
    np.testing.assert_array_equal(imp.numpy()[:, pad.numpy()], args[3][:, pad].numpy())
    assert (args[3][:7, pad] > 0).all()


def test_k4_wrapper_checks_its_inputs(bank):
    args = list(sweep.sweep_win_bank_args(bank, "cpu"))
    sb = bank["sb"]
    bad = list(args)
    bad[4] = args[4].long()
    with pytest.raises(TypeError, match="whi2"):
        sweep.contact_sweep_win(*bad, sb=sb, n_iters=1)
    bad = list(args)
    bad[1] = args[1][:8].contiguous()  # the streamed inertia has 16 rows
    with pytest.raises(ValueError, match="it_t"):
        sweep.contact_sweep_win(*bad, sb=sb, n_iters=1)
    bad = list(args)
    bad[3] = args[3].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        sweep.contact_sweep_win(*bad, sb=sb, n_iters=1)
    with pytest.raises(ValueError, match="slices"):
        sweep.contact_sweep_win(*args, sb=100, n_iters=1)
    order = sweep.window_order(args[4], args[5], args[7], sb)
    with pytest.raises(ValueError, match="order"):
        sweep.contact_sweep_win(*args, sb=sb, n_iters=1, order=order[:1].contiguous())
    before = sweep.contact_sweep_win.launches
    sweep.contact_sweep_win(*args, sb=sb, n_iters=1, order=order)
    assert sweep.contact_sweep_win.launches == before  # the CPU runs the plain version


def test_window_order_is_each_slices_stable_sort(bank):
    args = sweep.sweep_win_bank_args(bank, "cpu")
    sb = bank["sb"]
    order = sweep.window_order(args[4], args[5], args[7], sb)
    pos = sweep.window_positions(args[4], args[5], args[7], sb)
    assert order.dtype == torch.int32 and order.shape == pos.shape and order.is_contiguous()
    got = pos.gather(1, order.long())
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    ties = got[:, 1:] == got[:, :-1]
    assert bool((order[:, 1:] > order[:, :-1])[ties].all())  # equal positions keep entry order


def test_pack_inertia_rows_layout():
    a = torch.arange(21, dtype=torch.float32).reshape(3, 7)
    it = sweep.pack_inertia_rows(a, a + 100)
    assert it.shape == (sweep.IT_ROWS, 3) and it.is_contiguous()
    np.testing.assert_array_equal(it[:7].numpy(), a.T.numpy())
    np.testing.assert_array_equal(it[8:15].numpy(), (a + 100).T.numpy())
    assert (it[7] == 0).all() and (it[15] == 0).all()
