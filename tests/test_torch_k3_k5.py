"""K3's wave tables and K5's one-writer passes on the CPU, and the reason the card's
kernels give the bits of the walks they replace.

K3's table is K1's (``solver.solve.page_wave_table``) over one bank of the general path:
the pair store's pages in execution order, or a compound bucket's slices, built once per
step in ``solve_bucketed`` with the sums' writer-first order. The tests hold both to their
contract on real steps (a 4-ragdoll tube and a 16-ragdoll pile, small pages so that a
color spans several): within a wave of several slices, every written body (a valid row's
side with inertia) is named by no other valid row of the wave. Then a walk in which every
slice of a wave reads the state from the wave's start, and only the writing entries add
their deltas (what K3 does), equals ``_contact_sweep_plain`` bit for bit (int32 views: a
-0.0 velocity would show), and stops doing so when a Jacobi slice joins a wave.

K5 adds a pass's deltas from registers, one writer per body, when the wrapper flags the
pass's bodies pairwise distinct (``probes.distinct_passes``): the flag is held on the
probes' own inputs and on repeated bodies, and a host emulation of the one-writer walk
equals the plain version bit for bit. Imports no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from bepuphysics2_tpu_torch.experiments import sweep_proto
from bepuphysics2_tpu_torch.models import build_ragdoll_pile_sim, build_ragdoll_tube_sim
from bepuphysics2_tpu_torch.ops import probes, sweep
from test_torch_k1_k4_waves import _assert_same_bits, _bits, _capture, _contract, _join_first_tail

DT = 1 / 60


# --- K3: views, walks and banks ----------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The scenes are small: one torch thread steps them faster than a pool does, and
    leaves the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _k3_view(args, kw):
    """(positions, written entries, valid entries, live slices) of a K3 call, each entry
    (n_slices, 2 * sb) or slice (n_slices,)."""
    inertia7, ps_t, idx2 = args[1], args[2], args[4]
    sb = kw["sb"]
    live = (ps_t[sweep.PS_VALID].reshape(-1, sb) > 0.5).any(1)
    return (idx2.reshape(-1, 2 * sb).long(), sweep.sweep_writes(ps_t, inertia7, idx2, sb),
            sweep.row_valid(ps_t, sb), live)


def _k3_wave_walk(args, kw, waves):
    """``_contact_sweep_plain`` by waves: every slice of a wave reads the state from the
    wave's start, and only its writing entries add their deltas to the state after it."""
    v6, inertia7, ps_t, imp_t, _, scale, inv_h = args
    sb = kw["sb"]
    idx, writes, _, _ = _k3_view(args, kw)
    sc = scale.reshape(-1, 2 * sb)
    V, imp = v6.clone(), imp_t.clone()
    dep = ps_t[sweep.PS_DEPTH:sweep.PS_DEPTH + 4]
    for _ in range(kw["n_iters"]):
        for wave in sweep.wave_lists(waves):
            start = V.clone()
            for sl in wave:
                sweep._slice_pass(start, inertia7, ps_t, imp, dep, idx, sc, sl, sb, True, inv_h,
                                  dst=V, writes=writes)
    return [V, imp]


def _k3_plain(args, kw):
    return list(sweep._contact_sweep_plain(*args, sb=kw["sb"], n_iters=kw["n_iters"]))


SPC = (6, 6, 5, 6, 4, 6, 6, 6)  # slices per color: 8 colors, as phase 11's bank


def _k3_bank(n_jacobi=3):
    bank = sweep.synthetic_sweep_bank(336, 32, sum(SPC), n_jacobi, seed=4,
                                      slices_per_color=list(SPC))
    return bank, sweep.sweep_bank_args(bank, "cpu"), torch.from_numpy(bank["waves"])


def _k3_calls(sim, steps):
    """Every K3 call of ``steps`` steps of ``sim``, each as (args, kw)."""
    mp = pytest.MonkeyPatch()
    calls = _capture(mp, "contact_sweep")
    try:
        sim.run(steps, DT)
    finally:
        mp.undo()
    return calls


@pytest.fixture(scope="module")
def tube_calls():
    """The 4-ragdoll tube (2 substeps, 4 colors) in pages of 8 rows, once the ragdolls
    lie on the tube (56 steps): two steps' K3 calls, the store's and the compound
    bucket's per substep."""
    sim, _ = build_ragdoll_tube_sim(4, substeps=2, num_colors=4, device="cpu")
    sim.config = dataclasses.replace(sim.config, store_page=8)
    sim._dirty = True
    sim.run(56, DT)
    calls = _k3_calls(sim, 2)
    assert len(calls) == 2 * 2 * 2
    return calls


@pytest.fixture(scope="module")
def pile_calls():
    """A 16-ragdoll pile (169 bodies: the general path below 8,192 bodies) in pages of 16
    rows: two steps' K3 calls over the pair store's bucket."""
    sim, _ = build_ragdoll_pile_sim(16, substeps=2, num_colors=4, layer=(4, 4), device="cpu",
                                    store_page=16)
    sim.run(2, DT)
    calls = _k3_calls(sim, 2)
    assert len(calls) == 2 * 2
    return calls


def _scene_calls(scene, tube_calls, pile_calls):
    return tube_calls if scene == "tube" else pile_calls


# --- K3: the tables' contract on real steps ------------------------------------------------

@pytest.mark.parametrize("bank", ["store", "compound"])
def test_k3_table_contract_on_tube(tube_calls, bank):
    """Each bank's table over its own pages: the store's in execution order, the compound
    bucket's by color then Jacobi. The compound bucket's colors span several pages."""
    calls = tube_calls[0::2] if bank == "store" else tube_calls[1::2]
    sizes = []
    for args, kw in calls:
        sizes += _contract(kw["waves"], *_k3_view(args, kw))
    if bank == "compound":
        assert max(sizes) > 1


def test_k3_table_contract_on_ragdoll_pile(pile_calls):
    sizes = []
    for args, kw in pile_calls:
        sizes += _contract(kw["waves"], *_k3_view(args, kw))
    assert max(sizes) > 1


@pytest.mark.parametrize("scene", ["tube", "pile"])
def test_k3_order_lists_writing_entries_first(scene, tube_calls, pile_calls):
    """The order built once per step (from the bodies' inverse mass and local inertia) is
    ``writer_order`` over the entries K3 finds writing from each call's ``inertia7``."""
    for args, kw in _scene_calls(scene, tube_calls, pile_calls):
        idx, writes, _, _ = _k3_view(args, kw)
        assert torch.equal(kw["order"], sweep.writer_order(idx, writes))


# --- K3: waves read their start state: the walk's bits -------------------------------------

@pytest.mark.parametrize("n_iters", [1, 2])
def test_k3_wave_walk_equals_plain_walk_on_synthetic_bank(n_iters):
    bank, args, waves = _k3_bank()
    kw = dict(sb=bank["sb"], n_iters=n_iters)
    _contract(waves, *_k3_view(args, kw))
    want = _k3_plain(args, kw)
    _assert_same_bits(_k3_wave_walk(args, kw, waves), want)
    assert float((want[0] - args[0]).abs().max()) > 1e-2  # the sweep moved the bodies


@pytest.mark.parametrize("n_iters", [1, 2])
@pytest.mark.parametrize("scene", ["tube", "pile"])
def test_k3_wave_walk_equals_plain_walk_on_real_steps(scene, n_iters, tube_calls, pile_calls):
    for args, kw in _scene_calls(scene, tube_calls, pile_calls):
        kw = dict(sb=kw["sb"], n_iters=n_iters, waves=kw["waves"])
        _assert_same_bits(_k3_wave_walk(args, kw, kw["waves"]), _k3_plain(args, kw))


def test_k3_wave_walk_differs_when_a_jacobi_slice_joins_a_wave():
    bank, args, waves = _k3_bank()
    kw = dict(sb=bank["sb"], n_iters=2)
    assert [len(w) for w in sweep.wave_lists(waves)] == list(SPC) + [1, 1, 1]
    bad = _join_first_tail(waves)  # the first Jacobi slice joins the last color's wave
    with pytest.raises(AssertionError, match="shares a written body"):
        _contract(bad, *_k3_view(args, kw))
    got, want = _k3_wave_walk(args, kw, bad), _k3_plain(args, kw)
    assert not all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))


def test_synthetic_sweep_bank_colors_are_disjoint():
    """``slices_per_color``: each color's slices touch pairwise distinct dynamic bodies,
    one wave per color, Jacobi slices alone; without it the bank is as before."""
    bank, _, waves = _k3_bank()
    sb = bank["sb"]
    idx = bank["idx2"].reshape(-1, 2 * sb)
    valid = np.tile(bank["ps_t"][sweep.PS_VALID].reshape(-1, sb) > 0.5, 2)
    dyn = bank["inertia7"].any(1)
    first = np.cumsum([0] + list(SPC))
    for c in range(len(SPC)):
        rows = idx[first[c]:first[c + 1]][valid[first[c]:first[c + 1]]]
        bodies = rows[dyn[rows]]
        assert len(bodies) > sb and len(np.unique(bodies)) == len(bodies)
    assert [len(w) for w in sweep.wave_lists(waves)] == list(SPC) + [1, 1, 1]
    plain = sweep.synthetic_sweep_bank(64, 32, 2, 1, seed=3)
    again = sweep.synthetic_sweep_bank(64, 32, 2, 1, seed=3, slices_per_color=[1, 1])
    for k in ("idx2", "ps_t", "imp_t", "scale", "v6", "inertia7", "waves"):
        np.testing.assert_array_equal(plain[k], again[k])


def test_k3_wrapper_checks_the_order():
    bank, args, _ = _k3_bank()
    n = args[2].shape[1] // bank["sb"]
    with pytest.raises(ValueError, match="order has shape"):
        sweep.contact_sweep(*args, sb=bank["sb"], n_iters=1,
                            order=torch.zeros((n, bank["sb"]), dtype=torch.int32))
    with pytest.raises(TypeError, match="order has dtype"):
        sweep.contact_sweep(*args, sb=bank["sb"], n_iters=1,
                            order=torch.zeros((n, 2 * bank["sb"]), dtype=torch.int64))


@pytest.mark.cuda
def test_k3_card_wrapper_refuses_a_bad_wave_table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the table is checked on the card's route only")
    dev = torch.device("cuda")
    bank, _, waves = _k3_bank()
    args = sweep.sweep_bank_args(bank, dev)
    kw = dict(sb=bank["sb"], n_iters=1)
    waves = waves.to(dev)
    before = sweep.contact_sweep.launches
    with pytest.raises(ValueError, match="wave table"):
        sweep.contact_sweep(*args, **kw)
    with pytest.raises(ValueError, match="waves has shape"):
        sweep.contact_sweep(*args, **kw, waves=waves[:-1].contiguous())
    with pytest.raises(TypeError, match="waves has dtype"):
        sweep.contact_sweep(*args, **kw, waves=waves.long())
    with pytest.raises(ValueError, match="waves is on"):
        sweep.contact_sweep(*args, **kw, waves=waves.cpu())
    assert sweep.contact_sweep.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [1, 2])
def test_k3_card_matches_plain_on_synthetic_bank(n_iters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    bank, _, waves = _k3_bank()
    args = sweep.sweep_bank_args(bank, dev)
    kw = dict(sb=bank["sb"], n_iters=n_iters)
    got = sweep.contact_sweep(*args, **kw, waves=waves.to(dev))
    want = sweep._contact_sweep_plain(*args, **kw)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) < 1e-4
    again = sweep.contact_sweep(*args, **kw, waves=waves.to(dev))
    assert all(torch.equal(g, a) for g, a in zip(got, again))


# --- K5: the distinct flag and the one-writer pass ---------------------------------------

def test_k5_distinct_flag_on_the_probes_inputs():
    """Every pass of the probes' own inputs is a permutation slice: distinct. With
    repeated bodies, a pass is flagged exactly when no body repeats in it."""
    _, idx = sweep_proto.inputs()
    idx = torch.from_numpy(idx)
    assert bool(probes.distinct_passes(idx, probes._stable_order(idx)).all())
    _, dup = sweep_proto.inputs_with_duplicates()
    flags = probes.distinct_passes(torch.from_numpy(dup),
                                   probes._stable_order(torch.from_numpy(dup)))
    want = [len(np.unique(p)) == len(p) for p in dup]
    assert flags.dtype == torch.int32 and flags.tolist() == [int(w) for w in want]
    assert not any(want)
    mixed = torch.tensor([[3, 1, 2], [3, 1, 3], [0, 0, 0], [5, 4, 6]], dtype=torch.int32)
    assert probes.distinct_passes(mixed, probes._stable_order(mixed)).tolist() == [1, 0, 0, 1]


def _one_writer_walk(V, idx, distinct, lanes, mode):
    """K5's walk on (NB, 8) rows: a flagged pass of a mode that reads only its own body
    writes each row's S + d from its gathered values, one row at a time (any order: no
    two rows share a body); any other pass runs the plain pass."""
    V = V.clone()
    for rows, flag in zip(idx.long(), distinct.tolist()):
        if flag and mode in ("A", "B"):
            for r in torch.randperm(rows.numel(), generator=torch.Generator().manual_seed(0)):
                g = V[rows[r]].clone()
                V[rows[r]] = g + probes.math_block(g)
        else:
            probes._sweep_pass_plain(V, rows, lanes, mode)
    return V


@pytest.mark.parametrize("variant", ["v1", "v3", "v4"])
def test_k5_one_writer_walk_equals_plain(variant):
    name, _, lanes, transposed, mode = next(v for v in sweep_proto.VARIANTS if v[0] == variant)
    v6, idx = sweep_proto.inputs()
    v6, idx = torch.from_numpy(v6), torch.from_numpy(idx[:6])
    distinct = probes.distinct_passes(idx, probes._stable_order(idx))
    state = probes.to_state(v6, lanes, transposed)
    want = probes._probe_sweep_plain(state, idx, lanes, transposed, mode)
    got = probes.to_state(_one_writer_walk(v6, idx, distinct, lanes, mode), lanes, transposed)
    _assert_same_bits([got], [want])
    assert float((want - state).abs().max()) > 1e-1


def test_k5_one_writer_walk_equals_plain_on_repeated_bodies():
    v6, idx = sweep_proto.inputs_with_duplicates()
    v6, idx = torch.from_numpy(v6), torch.from_numpy(idx[:4])
    gen = torch.Generator().manual_seed(2)
    idx[1] = torch.randperm(sweep_proto.NB, generator=gen)[:sweep_proto.M]  # no body twice
    distinct = probes.distinct_passes(idx, probes._stable_order(idx))
    assert distinct.tolist() == [0, 1, 0, 0]
    want = probes._probe_sweep_plain(probes.to_state(v6, 128, False), idx, 128, False, "B")
    got = probes.to_state(_one_writer_walk(v6, idx, distinct, 128, "B"), 128, False)
    _assert_same_bits([got], [want])


def test_k5_wrapper_checks_the_distinct_flags():
    v6, idx = sweep_proto.inputs()
    state = probes.to_state(torch.from_numpy(v6), 128, False)
    idx = torch.from_numpy(idx)
    kw = dict(lanes=128, transposed=False)
    with pytest.raises(ValueError, match="distinct has shape"):
        probes.probe_sweep(state, idx, **kw, distinct=torch.ones(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="distinct has dtype"):
        probes.probe_sweep(state, idx, **kw, distinct=torch.ones(idx.shape[0], dtype=torch.bool))
    assert probes.sweep_smem_bytes(4096, 1024) == 180384


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v1", "v2-D", "v4"])
def test_k5_card_one_writer_and_run_sum_give_the_same_bits(variant):
    """On the card, the same passes flagged distinct (registers) and not (the ordered run
    sum) give the same bits, and both the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    _, fn, lanes, transposed, mode = next(v for v in sweep_proto.VARIANTS if v[0] == variant)
    v6, idx = sweep_proto.inputs()
    state = probes.to_state(torch.from_numpy(v6), lanes, transposed).to(dev)
    idx = torch.from_numpy(idx).to(dev)
    kw = dict(lanes=lanes, transposed=transposed, mode=mode)
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=dev)
    fast = probes.probe_sweep(state, idx, **kw, distinct=ones)
    walk = probes.probe_sweep(state, idx, **kw, distinct=torch.zeros_like(ones))
    assert torch.equal(fast.view(torch.int32), walk.view(torch.int32))
    want = probes._probe_sweep_plain(state, idx, lanes, transposed, mode)
    assert float((fast - want).abs().max()) <= 1e-5
