"""The wave tables of K1 and K4 on the CPU, and the reason the card's kernels may run a
wave's slices at once.

K1's table keys each page of its stream by color (``solver.solve.page_wave_table``), K4's
is K2's over the windowed store bucket (``solver.solve.wave_table``); both come from
``ops.sweep.waves_by_key``. The tests hold each table to its contract on real steps (a
pile through the store fast path, the contact-only compound pile, a small ragdoll pile on
the windowed general path): within a wave of several slices, every written body (a valid
row's side with inertia) is named by no other valid row of the wave. Then a walk in which
every slice of a wave reads the state from the wave's start, and only the writing entries
add their deltas (what the kernels do), equals the plain in-order walk bit for bit (int32
views: a -0.0 velocity would show), and stops doing so when a Jacobi slice joins a wave.
On a card, the wrappers refuse a missing or misshapen table. Imports no JAX."""
import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch import (
    BodyDescription, Box, SimConfig, Simulation, Sphere, StaticDescription,
)
from bepuphysics2_tpu_torch.models import build_compound_pile_sim, build_ragdoll_pile_sim
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


def _bits(ts):
    return [t.contiguous().view(torch.int32) for t in ts]


def _assert_same_bits(got, want):
    for g, w in zip(_bits(got), _bits(want)):
        assert torch.equal(g, w)


def _capture(monkeypatch, name):
    """Record every call of the kernel wrapper ``sweep.<name>`` (args, kwargs)."""
    calls = []
    fn = getattr(sweep, name)

    def wrapped(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    monkeypatch.setattr(sweep, name, wrapped)
    return calls


# --- the two kinds of bank: K1's page stream and K4's windowed bank ------------------------

def _k1_view(args, kw):
    """(positions, written entries, valid entries, live slices) of a K1 call, each entry
    (n_slices, 2 * sb) or slice (n_slices,)."""
    inv_mass, lii, ps_t, idx2 = args[3], args[4], args[7], args[9]
    sb = kw["sb"]
    idx = idx2.reshape(-1, 2 * sb).long()
    valid = sweep.row_valid(ps_t, sb)
    writes = valid & ~sweep.body_still(inv_mass, lii)[idx]
    live = (ps_t[sweep.PS_VALID].reshape(-1, sb) > 0.5).any(1)
    return idx, writes, valid, live


def _k4_view(args, kw):
    it_t, ps_t, whi2, wlo2, wseg = args[1], args[2], args[4], args[5], args[7]
    sb = kw["sb"]
    pos = sweep.window_positions(whi2, wlo2, wseg, sb)
    return pos, sweep.stream_writes(ps_t, it_t, sb), sweep.row_valid(ps_t, sb), wseg[:, 0] >= 0


def _contract(waves, pos, writes, valid, live):
    """Assert a wave table's contract; return the wave sizes. The waves cover the live
    slices in order; within a wave of several slices each written position is named by
    exactly one valid entry of the wave (its writer), so no two slices write one body and
    no slice reads what another writes."""
    lists = sweep.wave_lists(waves)
    assert [sl for w in lists for sl in w] == torch.nonzero(live).flatten().tolist()
    for w in lists:
        if len(w) == 1:
            continue
        named = pos[w][valid[w]]
        written = pos[w][writes[w]]
        counts = torch.bincount(named, minlength=int(pos.max()) + 1)
        assert bool((counts[written] == 1).all()), f"wave {w} shares a written body"
    return [len(w) for w in lists]


# --- walks: plain, and by waves as the kernels run them ------------------------------------

def _k1_wave_walk(args, kw, waves):
    """``_solve_substeps_contacts_plain`` by waves: every slice of a wave reads the state
    from the wave's start, and only its writing entries add their deltas to the state
    after it, in the wave's order."""
    (v6, pos, orn, inv_mass, lii, gm, im, ps_t, imp_t, _, scale, h, inv_h, lin_scale,
     ang_scale) = args
    sb = kw["sb"]
    n = ps_t.shape[1] // sb
    idx, writes, _, live = _k1_view(args, kw)
    sc = scale.reshape(n, 2 * sb)
    imp = imp_t.clone()
    dep = ps_t[sweep.PS_DEPTH:sweep.PS_DEPTH + 4].clone()
    live_col = live.repeat_interleave(sb)
    V = v6.clone()
    W = torch.zeros((V.shape[0], 7), dtype=torch.float32)
    for s in range(kw["n_substeps"]):
        if s > 0:
            new = sweep._inc_depth_rows(ps_t, dep, sweep._vel_of(V[idx[:, :sb].reshape(-1)]),
                                        sweep._vel_of(V[idx[:, sb:].reshape(-1)]), h)
            dep.copy_(torch.where(live_col, new, dep))
        pos, orn = sweep._pose_vel_inertia_block(
            V, W, pos, orn, inv_mass, lii, gm, im, h, lin_scale, ang_scale, kw["gravity"],
            kw["angular_mode"], s)
        for solve in [False] + [True] * kw["n_iters"]:
            for wave in sweep.wave_lists(waves):
                start = V.clone()
                for sl in wave:
                    sweep._slice_pass(start, W, ps_t, imp, dep, idx, sc, sl, sb, solve, inv_h,
                                      dst=V, writes=writes)
    return [V, torch.stack(list(pos)), torch.stack(list(orn)), imp]


def _k1_plain(args, kw):
    v6, pos, orn, imp = sweep._solve_substeps_contacts_plain(*args, **kw)
    return [v6, torch.stack(list(pos)), torch.stack(list(orn)), imp]


def _k4_wave_walk(args, kw, waves):
    """``_contact_sweep_win_plain`` by waves, as ``_k1_wave_walk``."""
    v6p, it_t, ps_t, imp_t, _, _, scale, _, inv_h = args
    sb = kw["sb"]
    pos, writes, _, _ = _k4_view(args, kw)
    sc = scale.reshape(-1, 2 * sb)
    V, imp = v6p.clone(), imp_t.clone()
    dep = ps_t[sweep.PS_DEPTH:sweep.PS_DEPTH + 4]
    for _ in range(kw["n_iters"]):
        for wave in sweep.wave_lists(waves):
            start = V.clone()
            for sl in wave:
                sweep._slice_pass(start, None, ps_t, imp, dep, pos, sc, sl, sb, True, inv_h,
                                  it_t=it_t, dst=V, writes=writes)
    return [V, imp]


def _k4_plain(args, kw):
    return list(sweep._contact_sweep_win_plain(*args, **kw))


KERNELS = {"K1": (_k1_view, _k1_wave_walk, _k1_plain),
           "K4": (_k4_view, _k4_wave_walk, _k4_plain)}


def _join_first_tail(waves):
    """The same table with the first one-slice wave after a wave of several slices merged
    into that wave (its key set to the wave's)."""
    lists = sweep.wave_lists(waves)
    n = (waves.shape[0] - 2) // 2
    key = torch.full((n,), -1, dtype=torch.long)
    live = torch.zeros(n, dtype=torch.bool)
    joined = None
    for k, w in enumerate(lists):
        for sl in w:
            live[sl] = True
            key[sl] = k if len(w) > 1 else -1
        if joined is None and len(w) == 1 and k > 0 and len(lists[k - 1]) > 1:
            joined = w[0]
            key[w[0]] = k - 1
    assert joined is not None, "no one-slice wave follows a color wave"
    return sweep.waves_by_key(key, live)


# --- banks ---------------------------------------------------------------------------------

def _k1_bank(slices_per_color=(3, 2, 1, 2), n_jacobi=2):
    bank = sweep.synthetic_bank(600, 128, sum(slices_per_color), n_jacobi, seed=3, substeps=2,
                                slices_per_color=list(slices_per_color))
    return bank, sweep.bank_args(bank, "cpu"), torch.from_numpy(bank["waves"])


def _k4_bank():
    bank = sweep.synthetic_win_bank(2600, 4096, 4, seed=9, substeps=4, wide_frac=0.05)
    return bank, sweep.sweep_win_bank_args(bank, "cpu"), torch.from_numpy(bank["waves"])


def _pile(n=600, layers=3):
    """``n`` spheres and boxes stacked ``layers`` high on a ground in columns apart, 4
    colors, on the store fast path through K1 in pages of 32 rows: each body touches the
    bodies above and below it, so a color holds several pages."""
    sim = Simulation(SimConfig(body_capacity=n + 64, max_pairs=8 * n, substeps=2, num_colors=4,
                               store_page=32), device="cpu")
    ground = sim.add_shape(Box(50.0, 0.5, 50.0))
    sim.add_static(StaticDescription(position=(0, -0.5, 0), shape=ground))
    s, b = Sphere(0.5), Box(0.5, 0.5, 0.5)
    ss, bs = sim.add_shape(s), sim.add_shape(b)
    side = int(np.ceil((n / layers) ** 0.5))
    for k in range(n):
        iy, rest = divmod(k, side * side)
        ix, iz = divmod(rest, side)
        p = (ix * 1.2 - side / 2, 0.5 + iy * 0.99, iz * 1.2 - side / 2)
        sim.add_body(BodyDescription.dynamic(p, *((ss, 1.0, s) if k % 2 == 0 else (bs, 1.0, b))))
    return sim


@pytest.fixture(scope="module")
def pile_calls():
    """Two steps of the pile: each step's K1 call."""
    mp = pytest.MonkeyPatch()
    calls = _capture(mp, "solve_substeps_contacts")
    try:
        _pile().run(2, 1 / 60)
    finally:
        mp.undo()
    assert len(calls) == 2
    return calls


@pytest.fixture(scope="module")
def compound_calls():
    """Two steps of the contact-only compound pile (252 bodies, phase 20's scene at 2
    substeps and 4 colors) once contacts have formed: each step's K1 call over the
    store's pages and then the compound bucket, with the store's page count."""
    sim, _ = build_compound_pile_sim(252, substeps=2, num_colors=4, device="cpu")
    sim.run(12, 1 / 60)
    mp = pytest.MonkeyPatch()
    calls = _capture(mp, "solve_substeps_contacts")
    try:
        sim.run(2, 1 / 60)
    finally:
        mp.undo()
    assert len(calls) == 2
    return calls, sim.state.store.page_color.shape[0]


@pytest.fixture(scope="module")
def ragdoll_calls():
    """Three steps of a 112-ragdoll pile (1,121 bodies: two Morton blocks, so a color's
    slices form waves) on the windowed general path: every K4 call."""
    mp = pytest.MonkeyPatch()
    calls = _capture(mp, "contact_sweep_win")
    try:
        sim, _ = build_ragdoll_pile_sim(112, substeps=2, num_colors=4, layer=(8, 7), device="cpu",
                                        solver_backend="pallas_win", broadphase="grid2")
        sim.run(3, 1 / 60)
    finally:
        mp.undo()
    assert len(calls) == 3 * 2
    return calls


def _plain_kw(kw):
    kw = dict(kw)
    waves = kw.pop("waves")
    kw.pop("order", None)
    return kw, waves


# --- the tables' contract on real steps ----------------------------------------------------

def test_k1_table_contract_on_store_page_stream(pile_calls):
    """The pile's page stream: pages by color, Jacobi pages after; a color of several
    live pages is one wave."""
    sizes = []
    for args, kw in pile_calls:
        kw, waves = _plain_kw(kw)
        sizes += _contract(waves, *_k1_view(args, kw))
    assert max(sizes) > 1


def test_k1_table_contract_on_compound_stream(compound_calls):
    """The compound pile's stream: the store's pages, then the compound bucket's; no wave
    spans the two banks."""
    calls, n_store = compound_calls
    for args, kw in calls:
        kw, waves = _plain_kw(kw)
        assert args[7].shape[1] // kw["sb"] > n_store  # the bucket follows the store's pages
        _contract(waves, *_k1_view(args, kw))
        lists = sweep.wave_lists(waves)
        for w in lists:
            assert w[0] >= n_store or w[-1] < n_store, f"wave {w} spans the two banks"
        assert lists[0][0] < n_store <= lists[-1][-1]  # both banks hold live slices


def test_k4_table_contract_on_ragdoll_pile(ragdoll_calls):
    """The windowed store bucket of a ragdoll pile: the table, and the sums' order
    (``writer_order``: the writing entries first, each part a stable sort of positions)."""
    sizes = []
    for args, kw in ragdoll_calls:
        pos, writes, valid, live = _k4_view(args, kw)
        sizes += _contract(kw["waves"], pos, writes, valid, live)
        assert torch.equal(kw["order"], sweep.writer_order(pos, writes))
    assert max(sizes) > 1


# --- waves read their start state: the walk's bits -----------------------------------------

@pytest.mark.parametrize("angular_mode", [0, 2])
def test_k1_wave_walk_equals_plain_walk_on_synthetic_bank(angular_mode):
    bank, args, waves = _k1_bank()
    kw = dict(sb=bank["sb"], n_substeps=2, n_iters=2, angular_mode=angular_mode,
              gravity=GRAVITY)
    _contract(waves, *_k1_view(args, kw))
    want = _k1_plain(args, kw)
    _assert_same_bits(_k1_wave_walk(args, kw, waves), want)
    assert float((want[0] - args[0]).abs().max()) > 1e-3  # the solve moved the bodies


def test_k4_wave_walk_equals_plain_walk_on_synthetic_bank():
    bank, args, waves = _k4_bank()
    kw = dict(sb=bank["sb"], n_iters=2)
    _contract(waves, *_k4_view(args, kw))
    want = _k4_plain(args, kw)
    _assert_same_bits(_k4_wave_walk(args, kw, waves), want)
    assert float((want[0] - args[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("scene", ["pile", "compound"])
def test_k1_wave_walk_equals_plain_walk_on_real_steps(scene, pile_calls, compound_calls):
    calls = pile_calls if scene == "pile" else compound_calls[0]
    for args, kw in calls:
        kw, waves = _plain_kw(kw)
        _assert_same_bits(_k1_wave_walk(args, kw, waves), _k1_plain(args, kw))


def test_k4_wave_walk_equals_plain_walk_on_ragdoll_pile(ragdoll_calls):
    for args, kw in ragdoll_calls:
        kw, waves = _plain_kw(kw)
        _assert_same_bits(_k4_wave_walk(args, kw, waves), _k4_plain(args, kw))


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_wave_walk_differs_when_a_jacobi_slice_joins_a_wave(kernel):
    """The same walk with a Jacobi (or wide) slice merged into the color wave before it:
    the slice then reads the state from before the wave, and the result changes."""
    if kernel == "K1":
        bank, args, waves = _k1_bank()
        kw = dict(sb=bank["sb"], n_substeps=2, n_iters=2, angular_mode=0, gravity=GRAVITY)
    else:
        bank, args, waves = _k4_bank()
        kw = dict(sb=bank["sb"], n_iters=2)
    view, walk, plain = KERNELS[kernel]
    bad = _join_first_tail(waves)
    with pytest.raises(AssertionError, match="shares a written body"):
        _contract(bad, *view(args, kw))
    got, want = walk(args, kw, bad), plain(args, kw)
    assert not all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))


# --- the pieces ----------------------------------------------------------------------------

def test_synthetic_bank_colors_are_disjoint():
    """``slices_per_color``: each color's slices touch pairwise distinct dynamic bodies,
    one wave per color, Jacobi slices alone; the default keeps a color per slice."""
    spc = [3, 2, 1, 2]
    bank, _, waves = _k1_bank(spc, n_jacobi=2)
    sb = bank["sb"]
    idx = bank["idx2"].reshape(-1, 2 * sb)
    valid = np.tile(bank["ps_t"][sweep.PS_VALID].reshape(-1, sb) > 0.5, 2)
    dyn = bank["inv_mass"] > 0
    first = np.cumsum([0] + spc)
    for c in range(len(spc)):
        rows = idx[first[c]:first[c + 1]][valid[first[c]:first[c + 1]]]
        bodies = rows[dyn[rows]]
        assert len(bodies) > sb and len(np.unique(bodies)) == len(bodies)
    assert [len(w) for w in sweep.wave_lists(waves)] == spc + [1, 1]
    plain = sweep.synthetic_bank(64, 128, 2, 1, seed=3, substeps=2)
    assert [len(w) for w in sweep.wave_lists(torch.from_numpy(plain["waves"]))] == [1, 1, 1]
    again = sweep.synthetic_bank(64, 128, 2, 1, seed=3, substeps=2, slices_per_color=[1, 1])
    for k in ("idx2", "ps_t", "imp_t", "scale", "v6", "waves"):
        np.testing.assert_array_equal(plain[k], again[k])
    with pytest.raises(ValueError, match="slices_per_color"):
        sweep.synthetic_bank(64, 128, 2, 1, seed=3, slices_per_color=[3])


def test_waves_by_key_layout():
    """Element 0 is W, then W + 1 starts (the live count after them), then the live
    slices; dead slices are in no wave and do not split one; a negative key is alone."""
    key = torch.tensor([0, 0, 0, 1, -1, -1, 5, 5])
    live = torch.tensor([True, False, True, True, True, True, True, False])
    waves = sweep.waves_by_key(key, live)
    assert waves.dtype == torch.int32 and waves.shape == (18,)
    assert sweep.wave_lists(waves) == [[0, 2], [3], [4], [5], [6]]
    assert waves.tolist()[:7] == [5, 0, 2, 3, 4, 5, 6]
    assert sweep.wave_shape(waves) == (5, [2], 4, 2)


def test_page_wave_table_keys_each_bank_apart():
    """Two banks of one stream: the second bank's color 0 does not join the first's; a
    bucket's slice k has color k // (cap / page), then Jacobi."""
    page, C = 4, 2
    colors = tsolve.bucket_page_colors(8, 20, page, C, "cpu")
    assert colors.tolist() == [0, 0, 1, 1, 2]
    store = torch.tensor([0, 1, 1, -1])
    ps = torch.zeros(sweep.PS_ROWS, 9 * page)
    ps[sweep.PS_VALID, :8 * page] = 1.0  # the store's empty page, sorted last, is live
    ps[sweep.PS_VALID, 3 * page:4 * page] = 0.0  # ... here not
    valid = ps[sweep.PS_VALID] > 0.5
    waves = tsolve.page_wave_table([store[:3], colors[:1]], valid[:4 * page], page, C)
    assert sweep.wave_lists(waves) == [[0], [1, 2]]  # no live slice of the bucket
    waves = tsolve.page_wave_table([store, torch.tensor([1, 1, 0, 0, 2])], valid, page, C)
    # The store's color-1 pages and the next bank's color-1 slices are consecutive live
    # slices of one color (the dead slice between them splits nothing): two waves.
    assert sweep.wave_lists(waves) == [[0], [1, 2], [4, 5], [6, 7]]
    waves = tsolve.page_wave_table([torch.cat([store, torch.tensor([1, 1, 0, 0, 2])])], valid,
                                   page, C)
    assert sweep.wave_lists(waves) == [[0], [1, 2, 4, 5], [6, 7]]  # one bank: one wave


def test_writer_order_puts_writing_entries_first():
    pos = torch.tensor([[5, 3, 5, 3, 1, 5]])
    writes = torch.tensor([[False, True, True, True, False, True]])
    order = sweep.writer_order(pos, writes)
    assert order.dtype == torch.int32 and order.tolist() == [[1, 3, 2, 5, 4, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_card_wrappers_refuse_a_bad_wave_table(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the table is checked on the card's route only")
    dev = torch.device("cuda")
    if kernel == "K1":
        bank, _, waves = _k1_bank()
        args = sweep.bank_args(bank, dev)
        kw = dict(sb=bank["sb"], n_substeps=2, n_iters=1, angular_mode=0, gravity=GRAVITY)
        fn = sweep.solve_substeps_contacts
    else:
        bank, _, waves = _k4_bank()
        args = sweep.sweep_win_bank_args(bank, dev)
        kw = dict(sb=bank["sb"], n_iters=1)
        fn = sweep.contact_sweep_win
    waves = waves.to(dev)
    before = fn.launches
    with pytest.raises(ValueError, match="wave table"):
        fn(*args, **kw)
    with pytest.raises(ValueError, match="waves has shape"):
        fn(*args, **kw, waves=waves[:-1].contiguous())
    with pytest.raises(TypeError, match="waves has dtype"):
        fn(*args, **kw, waves=waves.long())
    with pytest.raises(ValueError, match="waves is on"):
        fn(*args, **kw, waves=waves.cpu())
    assert fn.launches == before


def test_a_launch_beyond_a_blocks_shared_memory_raises_value_error():
    err = sweep._launch_failed("substeps_contacts", sweep._SMEM_TOO_LARGE, 4096, 8)
    assert isinstance(err, ValueError) and "shared memory" in str(err)
    other = sweep._launch_failed("substeps_contacts", 2, 512, 8)
    assert isinstance(other, RuntimeError) and "CUDA error 2" in str(other)


def _flat_k1(out):
    v6, pos, orn, imp = out
    return [v6, *pos, *orn, imp]


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [1024, 2048])
def test_k1_pages_too_large_to_stage_match_plain_on_card(sb):
    """Pages of 1,024 and 2,048 rows (SimConfig.store_page) do not fit K1's two stages in a
    block's shared memory: K1 reads their Jacobi pages from the bank instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's shared memory is sized on the card's route only")
    dev = torch.device("cuda")
    bank = sweep.synthetic_bank(2 * sb + 200, sb, 3, 2, seed=3, substeps=2,
                                slices_per_color=[2, 1])
    args = sweep.bank_args(bank, dev)
    kw = dict(sb=sb, n_substeps=2, n_iters=2, angular_mode=0, gravity=GRAVITY)
    got = sweep.solve_substeps_contacts(*args, **kw,
                                        waves=torch.from_numpy(bank["waves"]).to(dev))
    want = sweep._solve_substeps_contacts_plain(*args, **kw)
    assert max(float((g - w).abs().max()) for g, w in zip(_flat_k1(got), _flat_k1(want))) < 1e-4


@pytest.mark.cuda
def test_k1_refuses_pages_beyond_a_blocks_shared_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's shared memory is sized on the card's route only")
    dev = torch.device("cuda")
    bank = sweep.synthetic_bank(9000, 4096, 1, 1, seed=3, substeps=2)
    args = sweep.bank_args(bank, dev)
    before = sweep.solve_substeps_contacts.launches
    with pytest.raises(ValueError, match="shared memory"):
        sweep.solve_substeps_contacts(*args, sb=4096, n_substeps=2, n_iters=1, angular_mode=0,
                                      gravity=GRAVITY,
                                      waves=torch.from_numpy(bank["waves"]).to(dev))
    assert sweep.solve_substeps_contacts.launches == before
