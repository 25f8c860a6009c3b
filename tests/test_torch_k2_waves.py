"""K2's wave table (``solver/solve.py`` ``wave_table``) on the CPU: its contract on a
synthetic windowed bank and on a pile solved through the windowed path, and the reason K2
may run a wave's slices at once: a walk in which every slice of a wave reads the state
from the wave's start equals the plain in-order walk bit for bit. On a card, the K2
wrapper refuses a missing or misshapen table. Imports no JAX."""
import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch import (
    BodyDescription, Box, SimConfig, Simulation, Sphere, StaticDescription,
)
from bepuphysics2_tpu_torch.bodies import KIND_DYNAMIC
from bepuphysics2_tpu_torch.ops import sweep
from bepuphysics2_tpu_torch.solver import solve as tsolve

GRAVITY = (0.0, -10.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _capture(monkeypatch):
    """Record every ``win_pack`` result with its slot kinds and color count, and every K2
    call's arguments."""
    packs, calls = [], []
    pack, k2 = tsolve.win_pack, sweep.solve_substeps_contacts_win

    def win_pack(*a, **k):
        packs.append((pack(*a, **k), a[1], a[8]))
        return packs[-1][0]

    def solve(*a, **k):
        calls.append((a, k))
        return k2(*a, **k)

    monkeypatch.setattr(tsolve, "win_pack", win_pack)
    monkeypatch.setattr(sweep, "solve_substeps_contacts_win", solve)
    return packs, calls


@pytest.fixture(scope="module")
def synthetic():
    """The 2,600-body bank of the card tests (three Morton blocks, 4 colors, 5% wide
    rows), with its ``win_pack`` view."""
    mp = pytest.MonkeyPatch()
    packs, _ = _capture(mp)
    try:
        bank = sweep.synthetic_win_bank(2600, 4096, 4, seed=9, substeps=2, wide_frac=0.05)
    finally:
        mp.undo()
    assert bank["wide_rows"] > 0
    return bank, packs[0]


def _packed_pile(n=3000, steps=2):
    """A pile of ``n`` touching spheres and boxes on a ground, 4 colors, forced onto the
    windowed path (grid2): contacts from the first step, three Morton blocks."""
    sim = Simulation(SimConfig(body_capacity=n + 64, max_pairs=8 * n, substeps=2, num_colors=4,
                               solver_backend="pallas_win", broadphase="grid2"), device="cpu")
    ground = sim.add_shape(Box(50.0, 0.5, 50.0))
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = Sphere(0.5), Box(0.5, 0.5, 0.5)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    side = int(np.ceil(n ** (1 / 3)))
    for k in range(n):
        ix, iy, iz = np.unravel_index(k, (side, side, side))
        p = (ix * 0.98 - side / 2, 0.5 + iy * 0.98, iz * 0.98 - side / 2)
        sim.add_body(BodyDescription.dynamic(p, *((ss, 1.0, s) if k % 2 == 0 else (bs, 1.0, b))))
    return sim


@pytest.fixture(scope="module")
def pile():
    """Two steps of the packed pile: each step's ``win_pack`` view and K2 call."""
    mp = pytest.MonkeyPatch()
    packs, calls = _capture(mp)
    try:
        _packed_pile().run(2, 1 / 60)
    finally:
        mp.undo()
    assert len(packs) == len(calls) == 2
    return packs, calls


def _contract(wp, kind, num_colors):
    """Assert the table's contract; return the wave sizes."""
    sb = tsolve.SB_WIN
    waves = sweep.wave_lists(wp["waves"])
    live = np.nonzero(wp["wseg"][:, 0].numpy() >= 0)[0].tolist()
    assert [sl for w in waves for sl in w] == live  # every live slice once, in order
    gid = wp["rw"]["gid"].numpy()
    n_narrow, nblk = wp["rw"]["b_n"] // sb, wp["lay"]["nblk"]
    pos = sweep.window_positions(wp["whi2"], wp["wlo2"], wp["wseg"], sb).numpy()
    dyn = np.append(kind.numpy() == KIND_DYNAMIC, False)[wp["lay"]["pos_slot"].numpy()]
    for w in waves:
        colors = {int(gid[sl] // nblk) for sl in w}
        if any(sl >= n_narrow or gid[sl] < 0 or gid[sl] // nblk >= num_colors for sl in w):
            assert len(w) == 1  # Jacobi and wide slices are alone in their wave
            continue
        assert len(colors) == 1  # one color per wave
        touched = np.concatenate([np.unique(pos[sl][dyn[pos[sl]]]) for sl in w])
        assert len(np.unique(touched)) == len(touched)  # pairwise distinct dynamic bodies
    # A wave is maximal: two neighbouring waves never share a color c < C.
    for a, b in zip(waves, waves[1:]):
        ca, cb = gid[a[-1]] // nblk, gid[b[0]] // nblk
        assert not (len(a) > 1 and b[0] < n_narrow and ca == cb and ca < num_colors)
    return [len(w) for w in waves]


def test_wave_table_contract_on_synthetic_bank(synthetic):
    bank, (wp, kind, num_colors) = synthetic
    sizes = _contract(wp, kind, num_colors)
    assert max(sizes) > 1 and sizes.count(1) > 0  # both kinds of wave are exercised
    np.testing.assert_array_equal(wp["waves"].numpy(), bank["waves"])


def test_wave_table_contract_on_windowed_pile(pile):
    packs, _ = pile
    for wp, kind, num_colors in packs:
        sizes = _contract(wp, kind, num_colors)
        assert max(sizes) > 1


def test_wave_table_layout():
    """Element 0 is W, then W + 1 starts (the live count after them), then the live
    slices; dead slices are in no wave; each uncolored slice is a wave alone."""
    wseg = torch.tensor([[0] * 4, [-1] * 4, [0] * 4, [0] * 4, [0] * 4, [-1] * 4, [0] * 4],
                        dtype=torch.int32)
    # narrow: slices 0-4 (nblk 2: color = gid // 2, C = 2), wide: slices 5-6
    gid = torch.tensor([0, 0, 1, 4, 4, 7, 7], dtype=torch.int32)
    waves = tsolve.wave_table(wseg, gid, 5, 2, 2)
    assert waves.dtype == torch.int32 and waves.shape == (16,)
    assert waves.tolist() == [4, 0, 2, 3, 4, 5, 5, 5, 5, 0, 2, 3, 4, 6, -1, -1]
    assert sweep.wave_lists(waves) == [[0, 2], [3], [4], [6]]


def _wave_walk(v6p, pos_p, orn_p, inv_mass_p, lii_p, grav_mask_p, integ_mask_p, ps_t, imp_t,
               whi2, wlo2, scale, wseg, h, inv_h, lin_scale, ang_scale, *, sb, n_substeps,
               n_iters, angular_mode, gravity, waves):
    """``_solve_substeps_contacts_win_plain`` walked by waves: every slice of a wave reads
    the state as it was at the wave's start, and all of them add their deltas to the
    state after it, in the wave's order."""
    n_slices = ps_t.shape[1] // sb
    imp = imp_t.clone()
    dep = imp[sweep.IMP_ROWS:sweep.IMP_ROWS + 4]
    idx = sweep.window_positions(whi2, wlo2, wseg, sb)
    sc = scale.reshape(n_slices, 2 * sb).float()
    live_col = (wseg[:, 0] >= 0).repeat_interleave(sb)
    V = v6p.clone()
    W = torch.zeros((V.shape[0], 7), dtype=torch.float32)
    pos, orn = pos_p, orn_p
    for s in range(n_substeps):
        if s > 0:
            new_dep = sweep._inc_depth_rows(ps_t, dep, sweep._vel_of(V[idx[:, :sb].reshape(-1)]),
                                            sweep._vel_of(V[idx[:, sb:].reshape(-1)]), h)
            dep.copy_(torch.where(live_col, new_dep, dep))
        pos, orn = sweep._pose_vel_inertia_block(
            V, W, pos, orn, inv_mass_p, lii_p, grav_mask_p, integ_mask_p, h, lin_scale,
            ang_scale, gravity, angular_mode, s)
        for solve in [False] + [True] * n_iters:
            for wave in sweep.wave_lists(waves):
                start = V.clone()
                for sl in wave:
                    sweep._slice_pass(start, W, ps_t, imp[:sweep.IMP_ROWS], dep, idx, sc, sl, sb,
                                      solve, inv_h, dst=V)
    return V, pos, orn, imp


def _flat(out):
    v6, pos, orn, imp = out
    return [v6, torch.stack(list(pos)), torch.stack(list(orn)), imp]


def _assert_bitwise(args, kw, waves):
    want = _flat(sweep._solve_substeps_contacts_win_plain(*args, **kw))
    got = _flat(_wave_walk(*args, **kw, waves=waves))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float((got[0] - args[0]).abs().max()) > 1e-3  # the solve moved the bodies


@pytest.mark.parametrize("angular_mode", [0, 2])
def test_wave_walk_equals_plain_walk_on_synthetic_bank(synthetic, angular_mode):
    bank, _ = synthetic
    kw = dict(sb=bank["sb"], n_substeps=2, n_iters=2, angular_mode=angular_mode,
              gravity=GRAVITY)
    _assert_bitwise(sweep.win_bank_args(bank, "cpu"), kw, torch.from_numpy(bank["waves"]))


def test_wave_walk_equals_plain_walk_on_windowed_pile(pile):
    _, calls = pile
    for args, kw in calls:
        kw = dict(kw)
        waves = kw.pop("waves")
        _assert_bitwise(args, kw, waves)


def test_cpu_route_ignores_the_table(synthetic):
    """The plain route walks in order whatever table it is given."""
    bank, _ = synthetic
    args = sweep.win_bank_args(bank, "cpu")
    kw = dict(sb=bank["sb"], n_substeps=2, n_iters=1, angular_mode=0, gravity=GRAVITY)
    want = _flat(sweep.solve_substeps_contacts_win(*args, **kw))
    for waves in (None, torch.zeros(3, dtype=torch.int32)):
        got = _flat(sweep.solve_substeps_contacts_win(*args, **kw, waves=waves))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_k2_wrapper_refuses_a_bad_wave_table_on_card(synthetic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the table is checked on the card's route only")
    bank, _ = synthetic
    dev = torch.device("cuda")
    args = sweep.win_bank_args(bank, dev)
    kw = dict(sb=bank["sb"], n_substeps=2, n_iters=1, angular_mode=0, gravity=GRAVITY)
    waves = torch.from_numpy(bank["waves"]).to(dev)
    before = sweep.solve_substeps_contacts_win.launches
    with pytest.raises(ValueError, match="wave table"):
        sweep.solve_substeps_contacts_win(*args, **kw)
    with pytest.raises(ValueError, match="waves has shape"):
        sweep.solve_substeps_contacts_win(*args, **kw, waves=waves[:-1].contiguous())
    with pytest.raises(TypeError, match="waves has dtype"):
        sweep.solve_substeps_contacts_win(*args, **kw, waves=waves.long())
    with pytest.raises(ValueError, match="waves is on"):
        sweep.solve_substeps_contacts_win(*args, **kw, waves=waves.cpu())
    assert sweep.solve_substeps_contacts_win.launches == before
