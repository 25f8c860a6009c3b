"""Slice 2 of the PyTorch port against the JAX package on the CPU: the windowed layout
(``solver/windowing.py``), the ``grid2`` broad phase and kernel K2's plain version.

The same numpy-seeded inputs go through both packages. Integer outputs (layouts, windows,
pair lists, demand) must be equal, in order; K2 is held to the JAX kernel in interpret
mode to 1e-5, K1's bound."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bepuphysics2_tpu.bodies import KIND_DYNAMIC, KIND_EMPTY, KIND_KINEMATIC, KIND_STATIC
from bepuphysics2_tpu.collision import broadphase as jbroad
from bepuphysics2_tpu.ops import sweep as jsweep
from bepuphysics2_tpu.solver import windowing as jwin
from bepuphysics2_tpu.utils.vec import Quat as JQuat, Sym3 as JSym3, Vec3 as JVec3

from bepuphysics2_tpu_torch.collision import broadphase
from bepuphysics2_tpu_torch.ops import sweep
from bepuphysics2_tpu_torch.solver import windowing
from bepuphysics2_tpu_torch.utils.vec import Vec3

GRAVITY = (0.0, -10.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _scene(kind_name, seed):
    """(pos (nb, 3), kind (nb,)) of a windowing scene."""
    rng = np.random.default_rng(seed)
    if kind_name == "scattered":  # tests/test_pallas_sweep.py's layout scene
        nb = 512
        pos = rng.uniform(-50, 50, (nb, 3))
        kind = np.where(rng.uniform(size=nb) < 0.05, KIND_STATIC, KIND_DYNAMIC)
    elif kind_name == "duplicates":  # Morton codes tie: bodies share quantized cells
        nb = 300
        pos = np.repeat(rng.uniform(-5, 5, (60, 3)), 5, axis=0)
        pos[::7] += 1e-5
        kind = np.full(nb, KIND_DYNAMIC)
        kind[rng.choice(nb, 20, replace=False)] = KIND_STATIC
        kind[rng.choice(nb, 5, replace=False)] = KIND_KINEMATIC
        kind[-12:] = KIND_EMPTY
    else:  # "blocks": three Morton blocks, so rows cross block seams (wide rows)
        nb = 2600
        pos = rng.uniform(0, 40, (nb, 3))
        kind = np.where(rng.uniform(size=nb) < 0.02, KIND_STATIC, KIND_DYNAMIC)
        kind[-40:] = KIND_EMPTY
    return pos.astype(np.float32), kind.astype(np.int32)


WINDOW_CASES = [("scattered", 5, 256, 64, 192), ("duplicates", 6, 512, 64, 128),
                ("blocks", 7, 1536, 256, 512), ("blocks", 8, 1536, 256, 256)]


@pytest.mark.parametrize("scene,seed,B,sb,wide_cap", WINDOW_CASES)
def test_windowing_matches_jax(scene, seed, B, sb, wide_cap):
    pos, kind = _scene(scene, seed)
    nb = len(kind)
    rng = np.random.default_rng(seed + 100)
    a = rng.integers(0, nb, B).astype(np.int32)
    # Most rows join Morton neighbours; the rest join any two bodies.
    near = rng.uniform(size=B) < 0.7
    order = np.argsort(pos[:, 0])
    rank = np.argsort(order)
    a_near = order[np.clip(rank[a] + rng.integers(-3, 4, B), 0, nb - 1)]
    b = np.where(near, a_near, rng.integers(0, nb, B)).astype(np.int32)
    valid = rng.uniform(size=B) < 0.9
    color = rng.integers(0, 5, B).astype(np.int32)  # C = 4 plus the Jacobi color

    jpos, tpos = _both(pos)
    jkind, tkind = _both(kind)
    jlay = jwin.body_layout(JVec3(*(jpos[:, k] for k in range(3))), jkind)
    tlay = windowing.body_layout(Vec3(*(tpos[:, k].contiguous() for k in range(3))), tkind)
    for f in ("pos_slot", "slot_pos", "app_pos"):
        np.testing.assert_array_equal(tlay[f].numpy(), np.asarray(jlay[f]), err_msg=f)
    assert (tlay["nch"], tlay["nblk"]) == (jlay["nch"], jlay["nblk"])
    assert (np.asarray(jlay["app_pos"]) >= 0).sum() == ((kind != KIND_DYNAMIC)
                                                       & (kind != KIND_EMPTY)).sum()

    args = [_both(x) for x in (a, b, valid, color)]
    jrw = jwin.row_windows(jlay, *(x[0] for x in args), num_colors=4, sb=sb, wide_cap=wide_cap)
    trw = windowing.row_windows(tlay, *(x[1] for x in args), num_colors=4, sb=sb,
                                wide_cap=wide_cap)
    for f in ("dest", "wseg", "rel_a", "rel_b", "wide", "wide_overflow", "wide_demand"):
        np.testing.assert_array_equal(trw[f].numpy(), np.asarray(jrw[f]), err_msg=f)
    for f in ("b_n", "bp", "n_slices"):
        assert trw[f] == jrw[f], f
    if scene == "blocks":
        assert int(jrw["wide"].sum()) > 0  # the wide region is exercised
        if wide_cap == 256:
            # The wide region overflows: both packages leave out the same valid rows (the
            # windowed bucket of the substep loop, ROADMAP queue 3).
            assert bool(jrw["wide_overflow"])
            dropped = valid & (np.asarray(jrw["dest"]) == jrw["bp"])
            assert dropped.sum() > 0
            np.testing.assert_array_equal(valid & (trw["dest"].numpy() == trw["bp"]), dropped)
    M = np.random.default_rng(seed).normal(size=(B, 5)).astype(np.float32)
    jm, tm = _both(M)
    np.testing.assert_array_equal(
        windowing.scatter_rows(trw["dest"], trw["bp"], tm).numpy(),
        np.asarray(jwin.scatter_rows(jrw["dest"], jrw["bp"], jm)))
    X = rng.normal(size=(nb, 3)).astype(np.float32)
    jx, tx = _both(X)
    np.testing.assert_array_equal(windowing.permute_rows(tx, tlay["pos_slot"]).numpy(),
                                  np.asarray(jwin.permute_rows(jx, jlay["pos_slot"])))


def _bp_scene(seed, n=256, n_large=3, spread=14.0):
    """tests/test_broadphase.py's scene, as numpy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread / 2, spread / 2, (n, 3)).astype(np.float32)
    half = rng.uniform(0.3, 0.6, (n, 1)).astype(np.float32)
    amin, amax = c - half, c + half
    kind = np.full(n, KIND_DYNAMIC, np.int32)
    kind[: n // 8] = KIND_STATIC
    kind[-3:] = KIND_EMPTY
    awake = rng.random(n) > 0.1
    group = np.zeros(n, np.int32)
    group[10:20] = 7
    for i in range(n_large):
        amin[i] = (-spread, -1.0 - i, -spread)
        amax[i] = (spread, -i, spread)
    return amin, amax, kind, awake, group


def _dense_cluster(n=200):
    """tests/test_broadphase.py's dense cluster."""
    rng = np.random.default_rng(11)
    c = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    half = rng.uniform(0.2, 0.5, (n, 1)).astype(np.float32)
    return (c - half, c + half, np.full(n, KIND_DYNAMIC, np.int32), np.ones(n, bool),
            np.zeros(n, np.int32))


def _grid2_both(scene, max_pairs, *params, **kw):
    amin, amax, kind, awake, group = scene
    j = [_both(x) for x in (amin, amax, kind, awake, group)]
    jv = lambda x: JVec3(*(x[:, k] for k in range(3)))
    tv = lambda x: Vec3(*(x[:, k].contiguous() for k in range(3)))
    want = jbroad.grid2(jv(j[0][0]), jv(j[1][0]), j[2][0], j[3][0], j[4][0], max_pairs,
                        *params, **kw)
    got = broadphase.grid2(tv(j[0][1]), tv(j[1][1]), j[2][1], j[3][1], j[4][1], max_pairs,
                           *params, **kw)
    for f in ("a", "b", "valid", "overflow", "demand"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    return want


@pytest.mark.parametrize("seed", [0, 1, 2, 4])
@pytest.mark.parametrize("cell", [0.0, 1.4, 2.5])  # 0 = adaptive
def test_grid2_matches_jax_in_order(seed, cell):
    want = _grid2_both(_bp_scene(seed), 4096, cell, cell_capacity=32, max_large=32,
                       entry_factor=8)
    assert int(np.asarray(want.valid).sum()) > 100 and not bool(want.overflow)


def test_grid2_dense_cluster_and_even_count_median():
    """The dense cluster, with 200 live bodies (an even count: the adaptive cell takes the
    midpoint of the two middle extents), then with a small window and budget so that
    every overflow flag and demand counter is live."""
    scene = _dense_cluster()
    assert len(scene[2]) % 2 == 0
    _grid2_both(scene, 8192, 0.0, cell_capacity=64, max_large=16, entry_factor=8)
    # A fixed cell smaller than many boxes: the large set, the same-cell window and
    # max_pairs overflow, and report it.
    want = _grid2_both(scene, 512, 0.8, cell_capacity=4, max_large=16, entry_factor=2,
                       pair_k=4)
    d = np.asarray(want.demand)
    assert bool(want.overflow) and d[2] > 16 and d[4] == 1


def test_nanmedian_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 8):
        x = rng.uniform(0, 1, n).astype(np.float32)
        x[rng.uniform(size=n) < 0.3] = np.nan
        got = broadphase._nanmedian(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(jnp.asarray(x))))


# --- K2 ------------------------------------------------------------------------------

def _k2_bank():
    """64 bodies (NP 4,096); a 256-row bank with C = 4 (BP 1,792: 7 slices, 5 live)."""
    return sweep.synthetic_win_bank(64, 256, 4, seed=3, substeps=2)


def _jax_k2(bank, angular_mode):
    cols = lambda x: [jnp.asarray(x[:, j]) for j in range(x.shape[1])]
    a = lambda k: jnp.asarray(bank[k])
    return jsweep.solve_substeps_contacts_win(
        a("v6"), JVec3(*cols(bank["pos"])), JQuat(*cols(bank["orn"])), a("inv_mass"),
        JSym3(*cols(bank["local_inv_inertia"])), a("grav_mask"), a("integ_mask"), a("ps_t"),
        a("imp_t"), a("whi2"), a("wlo2"), a("scale"), a("wseg"), bank["h"], bank["inv_h"],
        1.0, 1.0, nch=bank["v6"].shape[0] // 8, sb=bank["sb"], n_substeps=2, n_iters=1,
        angular_mode=angular_mode, gravity=GRAVITY, interpret=True)


def _flat(out):
    v6, pos, orn, imp = out
    as_np = lambda t: np.asarray(t.cpu() if torch.is_tensor(t) else t)
    return (as_np(v6), np.stack([as_np(c) for c in pos]), np.stack([as_np(c) for c in orn]),
            as_np(imp))


def test_k2_bank_shape():
    bank = _k2_bank()
    assert bank["v6"].shape == (4096, 6) and bank["bp"] == 1792
    assert bank["wseg"].shape == (7, 4) and bank["live_slices"] == 5
    valid = bank["ps_t"][sweep.PS_VALID] > 0.5
    scale = bank["scale"].reshape(7, 2, 256)
    padding = np.broadcast_to(~valid.reshape(7, 1, 256), scale.shape)
    assert (scale[padding] == 1).all()  # padding rows read scale 1
    assert (scale > 1).any()  # Jacobi rows are mass-split
    np.testing.assert_array_equal(bank["imp_t"][8:12], bank["ps_t"][18:22])


@pytest.mark.parametrize("angular_mode", [0, 1, 2])
def test_plain_k2_matches_jax_kernel(angular_mode):
    bank = _k2_bank()
    want = _flat(_jax_k2(bank, angular_mode))
    got = _flat(sweep.solve_substeps_contacts_win(
        *sweep.win_bank_args(bank, "cpu"), sb=bank["sb"], n_substeps=2, n_iters=1,
        angular_mode=angular_mode, gravity=GRAVITY))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert np.abs(got[0] - bank["v6"]).max() > 1e-3  # the solve moved the bodies
    assert np.abs(got[3][:8] - bank["imp_t"][:8]).max() > 1e-4
    assert np.abs(got[3][8:12] - bank["imp_t"][8:12]).max() > 1e-6  # depths updated


def test_k2_wrapper_refuses_bad_inputs():
    bank = _k2_bank()
    args = list(sweep.win_bank_args(bank, "cpu"))
    kw = dict(sb=bank["sb"], n_substeps=2, n_iters=1, angular_mode=0, gravity=GRAVITY)
    bad = list(args)
    bad[9] = args[9].long()  # whi2 must be int32
    with pytest.raises(TypeError):
        sweep.solve_substeps_contacts_win(*bad, **kw)
    bad = list(args)
    bad[8] = args[8][:8].contiguous()  # the state has 16 rows
    with pytest.raises(ValueError):
        sweep.solve_substeps_contacts_win(*bad, **kw)
    with pytest.raises(ValueError):
        sweep.solve_substeps_contacts_win(*args, **dict(kw, sb=100))


def test_window_positions_resolve_rows_to_their_bodies():
    """Every valid row side of a windowed bank resolves, through its slice's window, to
    a layout position that holds its own body (tests/test_pallas_sweep.py's check)."""
    bank = sweep.synthetic_win_bank(2600, 4096, 4, seed=9, substeps=2, wide_frac=0.05)
    assert bank["wide_rows"] > 0
    pos2 = sweep.window_positions(torch.from_numpy(bank["whi2"]),
                                  torch.from_numpy(bank["wlo2"]),
                                  torch.from_numpy(bank["wseg"]), bank["sb"]).numpy()
    # Offsets to the partner (pos[b] - pos[a]) must equal the layout's positions.
    valid = (bank["ps_t"][sweep.PS_VALID] > 0.5).reshape(-1, bank["sb"])
    n_sl = valid.shape[0]
    pa = bank["pos"][pos2[:, :bank["sb"]]]
    pb = bank["pos"][pos2[:, bank["sb"]:]]
    off_b = bank["ps_t"][sweep.PS_B:sweep.PS_B + 3].T.reshape(n_sl, bank["sb"], 3)
    np.testing.assert_allclose((pb - pa)[valid], off_b[valid], atol=1e-5)
    assert (bank["wseg"][valid.any(1), 0] >= 0).all()
