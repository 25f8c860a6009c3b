"""Persistent slot-stable contact pair store (counterpart of
``bepuphysics2_tpu/collision/pairstore.py``; reference PairCache.cs:102, Solver.cs:984).

A pair keeps ONE slot for its whole life, with its color, features and accumulated
impulses in place. Slots group into color-homogeneous pages; Jacobi-fallback rows live in
pages of color C. Membership is an (HB, 8)-lane bucket hash; color claims are a per-body
bitmask. Every function here keeps the JAX function's arguments and results.

Scatters are written so that the result never depends on which of two writers wins:
JAX's ``mode="drop"`` writes into one extra sink row that is sliced off, targets of a
``set`` are unique (or carry one value), integer reductions go through
``index_add``/``scatter_reduce``, and the float adds carry whole numbers (valence counts),
which sum exactly in any order. That keeps the store bit-identical run to run on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bodies import KIND_DYNAMIC, KIND_EMPTY

EMPTY = -1
LANES = 8  # hash bucket width
I32 = torch.int32


class PairStore(NamedTuple):
    """Persistent pair world. B slots = P pages × page rows."""

    body_a: torch.Tensor  # (B,) int32
    body_b: torch.Tensor  # (B,) int32
    live: torch.Tensor  # (B,) bool — slot holds a pair
    active_prev: torch.Tensor  # (B,) bool — last frame's prestep.valid
    color: torch.Tensor  # (B,) int32 — 0..C-1, or C (Jacobi pages)
    hpos: torch.Tensor  # (B,) int32 — flat hash position bucket*LANES + lane
    feature: torch.Tensor  # (B, 4) int32 — -1 = no prior contact
    imp_pen: torch.Tensor  # (B, 4) f32 accumulated impulses
    imp_tx: torch.Tensor  # (B,)
    imp_ty: torch.Tensor  # (B,)
    imp_tw: torch.Tensor  # (B,)
    used: torch.Tensor  # (NB+1,) int32 color-claim bitmask per body
    jacv: torch.Tensor  # (NB+1,) f32 per-body count of live Jacobi rows
    ht: torch.Tensor  # (HB*LANES, 3) int32 hash lanes [body_a, body_b, slot]; -1 = empty
    page_color: torch.Tensor  # (P,) int32 — -1 = empty page

    @staticmethod
    def empty(capacity: int, n_bodies: int, page: int, device=None) -> "PairStore":
        assert capacity % page == 0
        p = capacity // page
        hb = max(8, _next_pow2(-(-capacity // 2)))
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
        return PairStore(
            body_a=z(capacity, I32),
            body_b=z(capacity, I32),
            live=z(capacity, torch.bool),
            active_prev=z(capacity, torch.bool),
            color=z(capacity, I32),
            hpos=z(capacity, I32),
            feature=torch.full((capacity, 4), -1, dtype=I32, device=device),
            imp_pen=z((capacity, 4), torch.float32),
            imp_tx=z(capacity, torch.float32),
            imp_ty=z(capacity, torch.float32),
            imp_tw=z(capacity, torch.float32),
            used=z(n_bodies + 1, I32),
            jacv=z(n_bodies + 1, torch.float32),
            ht=torch.full((hb * LANES, 3), -1, dtype=I32, device=device),
            page_color=torch.full((p,), -1, dtype=I32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.body_a.shape[0]

    @property
    def n_pages(self) -> int:
        return self.page_color.shape[0]

    @property
    def page(self) -> int:
        return self.capacity // self.n_pages


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value with the same low 32 bits (two's complement wrap)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _hash_bucket(a, b, hb: int):
    """Deterministic bucket id for a pair (int32 wrap-around arithmetic)."""
    h = _wrap32(a.long() * -1640531527 + b.long() * 97001)
    h = h ^ (h >> 15)
    return (h & (hb - 1)).to(I32)


def _set_drop(dst, idx, val):
    """``dst.at[idx].set(val, mode="drop")`` for idx in [0, len(dst)]: index len(dst) is
    a sink row that is sliced off. A Python constant is filled in place (``index_fill_``
    takes it as a kernel argument, where indexing would copy it to the device)."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    if torch.is_tensor(val):
        ext[idx.long()] = val
    else:
        ext.index_fill_(0, idx.long(), val)
    return ext[:n]


def _add(dst, idx, val):
    """``dst.at[idx].add(val)`` for in-range idx (integer or whole-number float adds)."""
    if not torch.is_tensor(val):
        val = torch.full(idx.shape, val, dtype=dst.dtype, device=dst.device)
    return dst.index_add(0, idx.long(), val.to(dst.dtype))


def _shl1(n):
    """1 << n for an int32 tensor n."""
    return torch.bitwise_left_shift(torch.ones_like(n), n)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _compact(mask: torch.Tensor, cap: int):
    """Ascending indices of True (padded with the input size) via cumsum + one scatter.
    Returns (idx (cap,) int32, count, overflow)."""
    m = mask.shape[0]
    rank = torch.cumsum(mask.to(I32), 0) - 1
    kept = mask & (rank < cap)
    out = torch.full((cap + 1,), m, dtype=I32, device=mask.device)
    out[torch.where(kept, rank, cap).long()] = torch.arange(m, dtype=I32, device=mask.device)
    count = mask.sum()
    return out[:cap], torch.clamp_max(count, cap), count > cap


def update(
    store: PairStore,
    kind, awake, group,
    aabb_min, aabb_max,
    cand_a, cand_b, cand_valid,
    cand_insertable,
    num_colors: int,
    ext_used,
    churn_cap: int,
    dead_cap: int,
    repair_cap: int,
):
    """One frame of store maintenance: retire separated pairs, admit new broad-phase
    pairs (color + page slot assignment), and retry colors for Jacobi rows.
    Returns (store', overflow, demand (3,) [admissions, retirements, live], active)."""
    dev = kind.device
    B = store.capacity
    NB = kind.shape[0]
    C = num_colors
    P = store.n_pages
    page = store.page
    hb = store.ht.shape[0] // LANES
    maskC = (1 << C) - 1
    ar = lambda n: torch.arange(n, dtype=I32, device=dev)

    a0, b0 = store.body_a, store.body_b
    a0l, b0l = a0.long(), b0.long()

    # ---- liveness of stored pairs (bodies exist, one dynamic, AABBs overlap, no group
    # filter). Sleeping pairs survive in place.
    brow = torch.stack(
        [
            aabb_min.x, aabb_min.y, aabb_min.z, aabb_max.x, aabb_max.y, aabb_max.z,
            kind.float(), group.float(), ((kind == KIND_DYNAMIC) & awake).float(),
        ],
        -1,
    )
    ra = brow[a0l]
    rb = brow[b0l]
    overlap = (
        (ra[:, 0] <= rb[:, 3]) & (rb[:, 0] <= ra[:, 3])
        & (ra[:, 1] <= rb[:, 4]) & (rb[:, 1] <= ra[:, 4])
        & (ra[:, 2] <= rb[:, 5]) & (rb[:, 2] <= ra[:, 5])
    )
    ka = ra[:, 6].to(I32)
    kb = rb[:, 6].to(I32)
    ga = ra[:, 7].to(I32)
    gb = rb[:, 7].to(I32)
    ok = (
        overlap
        & (ka != KIND_EMPTY) & (kb != KIND_EMPTY)
        & ((ka == KIND_DYNAMIC) | (kb == KIND_DYNAMIC))
        & ((ga != gb) | (ga == 0))
    )
    row_awake = (ra[:, 8] > 0) | (rb[:, 8] > 0)
    dead = store.live & ~ok
    dsel, _, _ = _compact(dead, dead_cap)
    dsel_c = torch.clamp_max(dsel, B - 1).long()
    d_live = dsel < B
    # Clear hash lanes + unclaim colors of retired rows.
    dh = torch.where(d_live, store.hpos[dsel_c], hb * LANES)
    ht = _set_drop(store.ht, dh, EMPTY)
    dcol = store.color[dsel_c]
    dbit = torch.where(d_live & (dcol < C), _shl1(dcol.clamp_min(0)), 0)
    da = a0[dsel_c]
    db = b0[dsel_c]
    da_dyn = kind[da.long()] == KIND_DYNAMIC
    db_dyn = kind[db.long()] == KIND_DYNAMIC
    used = _add(store.used, torch.where(d_live & da_dyn, da, NB), -dbit)
    used = _add(used, torch.where(d_live & db_dyn, db, NB), -dbit)
    djac = torch.where(d_live & (dcol == C), -1.0, 0.0)
    jacv = _add(store.jacv, torch.where(d_live, da, NB), djac)
    jacv = _add(jacv, torch.where(d_live, db, NB), djac)
    live = store.live & ~_set_drop(
        torch.zeros(B, dtype=torch.bool, device=dev), torch.where(d_live, dsel_c, B), True
    )

    # ---- membership probe for every candidate: one packed row gather.
    cb = _hash_bucket(cand_a, cand_b, hb)
    htr = ht.reshape(hb, LANES * 3)[cb.long()].reshape(-1, LANES, 3)
    hit = (
        (htr[:, :, 0] == cand_a[:, None])
        & (htr[:, :, 1] == cand_b[:, None])
        & (htr[:, :, 2] >= 0)
    )
    found = cand_valid & hit.any(dim=1)
    new = cand_valid & ~found & cand_insertable

    # ---- admit new pairs (churn-bounded).
    nsel, _, n_ovfl = _compact(new, churn_cap)
    overflow = n_ovfl
    nsel_c = torch.clamp_max(nsel, cand_a.shape[0] - 1).long()
    n_liv = nsel < cand_a.shape[0]
    na = torch.where(n_liv, cand_a[nsel_c], 0)
    nb_ = torch.where(n_liv, cand_b[nsel_c], 0)

    # Hash lane: the rank-th free lane of the bucket, rank = order among this frame's
    # new rows sharing the bucket.
    nbk = _hash_bucket(na, nb_, hb)
    occ = ht.reshape(hb, LANES, 3)[nbk.long()][:, :, 2] >= 0
    order = torch.argsort(torch.where(n_liv, nbk, hb), stable=True)
    nbk_s = nbk[order]
    seg_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nbk_s[1:] != nbk_s[:-1]])
    seg_id = (torch.cumsum(seg_new.to(I32), 0) - 1).long()
    seg_start = torch.zeros(churn_cap, dtype=I32, device=dev).scatter_reduce(
        0, seg_id, ar(churn_cap) * seg_new.to(I32), "amax", include_self=True
    )
    pos_in_seg = ar(churn_cap) - seg_start[seg_id]
    brank = torch.zeros(churn_cap, dtype=I32, device=dev)
    brank[order] = pos_in_seg
    free_rank = torch.cumsum((~occ).to(I32), 1) - 1
    lane_match = (~occ) & (free_rank == brank[:, None])
    has_lane = lane_match.any(dim=1)
    lane = torch.argmax(lane_match.to(I32), dim=1).to(I32)
    n_ok = n_liv & has_lane
    overflow = overflow | (n_liv & ~has_lane).any()

    # ---- color proposals for new rows and for Jacobi retries (repair set).
    rmask = live & (store.color == C)
    rsel, _, _ = _compact(rmask, repair_cap)
    rsel_c = torch.clamp_max(rsel, B - 1).long()
    r_liv = rsel < B
    ra_ = torch.where(r_liv, a0[rsel_c], 0)
    rb_ = torch.where(r_liv, b0[rsel_c], 0)

    cc = churn_cap + repair_cap
    pa = torch.cat([na, ra_])
    pb = torch.cat([nb_, rb_])
    pal, pbl = pa.long(), pb.long()
    p_live = torch.cat([n_ok, r_liv])
    is_new = torch.cat([torch.ones(churn_cap, dtype=torch.bool, device=dev),
                        torch.zeros(repair_cap, dtype=torch.bool, device=dev)])

    # Only dynamic endpoints conflict.
    dyn_a = kind[pal] == KIND_DYNAMIC
    dyn_b = kind[pbl] == KIND_DYNAMIC

    used_all = used | ext_used
    page_live = live.reshape(P, page).sum(dim=1)
    page_col = torch.where(page_live > 0, store.page_color, -1)
    page_free = page - page_live
    cols = ar(C + 1)
    cap_c = torch.where(page_col[None, :] == cols[:, None], page_free[None, :], 0).sum(dim=1)
    n_empty = (page_col == -1).sum()
    full_bits = torch.where(
        (cap_c[:C] == 0) & (n_empty == 0), _shl1(cols[:C]), 0
    ).sum().to(I32)

    slotarr = ar(cc)
    pcolor = torch.full((cc,), C, dtype=I32, device=dev)
    pactive = p_live
    sink = NB * C
    big_p = 2**31 - 1
    p32 = _wrap32(pa.long() * -1640531527 + pb.long() * 40503)
    p_abs = torch.where(p32 == -(2**31), p32, p32.abs())  # int32 abs keeps INT_MIN
    pref = torch.remainder(p_abs, C).to(I32)
    idx_a = torch.where(dyn_a, pa, NB).long()
    idx_b = torch.where(dyn_b, pb, NB).long()
    for _ in range(2):
        ua = torch.where(dyn_a, used_all[idx_a], 0)
        ub = torch.where(dyn_b, used_all[idx_b], 0)
        avail = (~(ua | ub)) & maskC & ~full_bits
        has = pactive & (avail != 0)
        rot = (torch.bitwise_right_shift(avail, pref)
               | torch.bitwise_left_shift(avail, C - pref)) & maskC
        low = rot & (-rot)
        idx = torch.round(torch.log2(low.clamp_min(1).float())).to(I32)
        prop = torch.remainder(idx + pref, C)
        tgt_a = torch.where(dyn_a & has, pa * C + prop, sink).long()
        tgt_b = torch.where(dyn_b & has, pb * C + prop, sink).long()
        table = torch.full((NB * C + 1,), big_p, dtype=I32, device=dev)
        table = table.scatter_reduce(0, tgt_a, slotarr, "amin", include_self=True)
        table = table.scatter_reduce(0, tgt_b, slotarr, "amin", include_self=True)
        win = has & (~dyn_a | (table[tgt_a] == slotarr)) & (~dyn_b | (table[tgt_b] == slotarr))
        pcolor = torch.where(win, prop, pcolor)
        pactive = pactive & ~win
        wbit = torch.where(win, _shl1(prop), 0)
        used_all = _add(used_all, idx_a, torch.where(dyn_a, wbit, 0))
        used_all = _add(used_all, idx_b, torch.where(dyn_b, wbit, 0))

    # Repair rows that failed keep their Jacobi slot (no move, no write).
    moving = p_live & (is_new | (pcolor < C))

    # ---- page slot allocation, per final color, demoting on shortfall.
    esel, _, _ = _compact(page_col == -1, P)
    elig = page_col[None, :] == cols[:, None]  # (C+1, P)
    pc = torch.cumsum(torch.where(elig, page_free[None, :], 0), dim=1)  # (C+1, P)
    total_c = pc[:, -1]

    def alloc(colors, active):
        """colors (cc,) in [0..C] → (page, row-in-page, got, in_existing_page)."""
        cl = colors.long()
        onehot = (colors[:, None] == cols[None, :]) & active[:, None]
        k = torch.cumsum(onehot.to(I32), dim=0) - 1
        krow = torch.where(onehot, k, 0).sum(dim=1)
        demand = onehot.sum(dim=0)
        extra = torch.clamp_min(demand - total_c, 0)
        npages = -_fdiv(-extra, page)
        np_pref = torch.cumsum(npages, 0) - npages
        tc = total_c[cl]
        can_new = (np_pref[cl] + _fdiv(torch.clamp_min(krow - tc, 0), page)) < n_empty
        got = active & ((krow < tc) | can_new)
        pcs = pc[cl]  # (cc, P)
        pidx = (pcs <= krow[:, None]).to(I32).sum(dim=1)
        pidx_c = torch.clamp_max(pidx, P - 1)
        base = torch.where(
            pidx > 0,
            torch.gather(pcs, 1, torch.clamp_min(pidx - 1, 0).long()[:, None])[:, 0],
            0,
        )
        j_exist = krow - base
        in_exist = krow < tc
        k2 = torch.clamp_min(krow - tc, 0)
        e_idx = torch.clamp_max(np_pref[cl] + _fdiv(k2, page), P - 1)
        fresh_page_c = torch.clamp_max(esel[e_idx.long()], P - 1)
        j_fresh = torch.remainder(k2, page)
        pg = torch.where(in_exist, pidx_c, fresh_page_c)
        jj = torch.where(in_exist, j_exist, j_fresh)
        return pg, jj, got, in_exist

    # Free-slot rank table: slot of the j-th free slot within each page.
    free = ~live
    fr = torch.cumsum(free.reshape(P, page).to(I32), dim=1) - 1
    fs_idx = torch.where(free, _fdiv(ar(B), page) * page + fr.reshape(-1), P * page)
    free_slot = torch.full((P * page + 1,), B, dtype=I32, device=dev)
    free_slot[fs_idx.long()] = ar(B)
    free_slot = free_slot[: P * page].reshape(P, page)

    _, _, got1, _ = alloc(pcolor, moving)
    retry = moving & ~got1
    still_moving = moving & (got1 | is_new)  # failed repair rows stay put
    pcolor_f = torch.where(retry, C, pcolor)
    pg, jj, got, _ = alloc(pcolor_f, still_moving)
    overflow = overflow | (still_moving & ~got).any()
    place = still_moving & got
    new_slot = torch.where(
        place,
        free_slot[torch.clamp_max(pg, P - 1).long(), torch.clamp_max(jj, page - 1).long()],
        B,
    )
    place = place & (new_slot < B)

    # ---- write phase ----------------------------------------------------------------
    w = torch.where(place, new_slot, B)
    # Every row placed into one page carries that page's color: one value per target.
    page_color_new = _set_drop(page_col, torch.where(place, pg, P), pcolor_f)

    wbit2 = torch.where(place & (pcolor_f < C), _shl1(torch.clamp_max(pcolor_f, C - 1)), 0)
    used2 = _add(used, idx_a, torch.where(dyn_a, wbit2, 0))
    used2 = _add(used2, idx_b, torch.where(dyn_b, wbit2, 0))
    jd = torch.where(
        place & is_new & (pcolor_f == C), 1.0,
        torch.where(place & ~is_new, -1.0, 0.0),
    )
    jacv2 = _add(jacv, torch.where(place, pa, NB), jd)
    jacv2 = _add(jacv2, torch.where(place, pb, NB), jd)

    # Moved repair rows: free the old slot, carry impulses/features.
    mv = place & ~is_new
    old_slot = torch.cat([torch.full((churn_cap,), B, dtype=I32, device=dev), rsel])
    old_c = torch.clamp_max(old_slot, B - 1).long()
    live2 = _set_drop(live, torch.where(mv, old_c, B), False)
    live2 = _set_drop(live2, w, True)

    carry = lambda col, newv: _set_drop(col, w, newv)
    isn = is_new[:, None]
    feat_new = torch.where(isn, -1, store.feature[old_c])
    pen_new = torch.where(isn, 0.0, store.imp_pen[old_c])
    tx_new = torch.where(is_new, 0.0, store.imp_tx[old_c])
    ty_new = torch.where(is_new, 0.0, store.imp_ty[old_c])
    tw_new = torch.where(is_new, 0.0, store.imp_tw[old_c])
    ap_new = ~is_new & store.active_prev[old_c]
    hp_new = torch.where(
        is_new,
        torch.cat([nbk * LANES + lane, torch.zeros(repair_cap, dtype=I32, device=dev)]),
        store.hpos[old_c],
    )

    store2 = store._replace(
        body_a=carry(a0, pa),
        body_b=carry(b0, pb),
        live=live2,
        active_prev=carry(store.active_prev, ap_new),
        color=carry(store.color, pcolor_f),
        hpos=carry(store.hpos, hp_new),
        feature=carry(store.feature, feat_new),
        imp_pen=carry(store.imp_pen, pen_new),
        imp_tx=carry(store.imp_tx, tx_new),
        imp_ty=carry(store.imp_ty, ty_new),
        imp_tw=carry(store.imp_tw, tw_new),
        used=used2,
        jacv=jacv2,
        # One packed-row scatter covers inserts and moved-row slot updates; placed rows
        # own distinct lanes (new rows take free lanes, moved rows keep theirs).
        ht=_set_drop(ht, torch.where(place, hp_new, hb * LANES),
                     torch.stack([pa, pb, new_slot], -1)),
        page_color=page_color_new,
    )
    demand = torch.stack([new.sum(), dead.sum(), live2.sum()]).to(I32)
    act_new = is_new | row_awake[old_c]
    active_out = live2 & _set_drop(row_awake, w, act_new)
    return store2, overflow, demand, active_out


def exec_order(store: PairStore, num_colors: int):
    """Page execution permutation: pages by color ascending, Jacobi (C) pages after all
    colored pages, empty pages last. Returns (perm, page_is_jacobi in exec order, inv)."""
    P = store.n_pages
    key = torch.where(store.page_color < 0, num_colors + 1, store.page_color)
    perm = torch.argsort(key, stable=True).to(I32)
    inv = torch.zeros(P, dtype=I32, device=key.device)
    inv[perm.long()] = torch.arange(P, dtype=I32, device=key.device)
    is_jac = key[perm.long()] == num_colors
    return perm, is_jac, inv


def jacobi_counts(body_a, body_b, jac_mask, n_bodies: int, cap: int):
    """Per-body count (NB+1,) f32 of Jacobi rows (mass-splitting valence). The JAX
    package picks a compacted or a full-bank scatter at run time; both give the same
    exact counts, so the port always takes the full-bank one (no host sync). ``cap`` is
    kept for the JAX signature."""
    one = jac_mask.float()
    out = torch.zeros(n_bodies + 1, dtype=torch.float32, device=body_a.device)
    out = _add(out, torch.where(jac_mask, body_a, n_bodies), one)
    return _add(out, torch.where(jac_mask, body_b, n_bodies), one)


def store_claims(bodies, colors, valid, n_bodies: int, num_colors: int):
    """Claim bitmask (NB+1,) from an external bank's persisted colors.
    ``bodies``: (M, k) int32; colors (M,) with -1/C = no claim."""
    _, k = bodies.shape
    bit = torch.where(valid & (colors >= 0) & (colors < num_colors),
                      _shl1(colors.clamp_min(0)), 0)
    out = torch.zeros(n_bodies + 1, dtype=I32, device=bodies.device)
    for j in range(k):
        out = _add(out, torch.clamp_max(bodies[:, j], n_bodies), bit)
    return out


def migrate(store: PairStore, new_capacity: int, n_bodies: int, new_page: int,
            num_colors: int, kind=None) -> PairStore:
    """Host-side store resize that keeps every live pair's color, features and
    accumulated impulses (reference Simulation.EnsureCapacity moves its caches). Runs
    between steps in numpy, as the JAX package's ``migrate`` does: live rows re-place into
    fresh color-homogeneous pages in color order, the hash re-inserts them with the
    device's bucket function, and the claim and valence tables rebuild from the carried
    rows. Rows past the new capacity, or past a full hash bucket, drop; the broad phase
    re-admits them. ``kind`` (host array) decides which endpoints claim colors: only
    dynamic ones, as in ``update``. The result lies on the store's device."""
    import numpy as np

    assert new_capacity % new_page == 0
    P = new_capacity // new_page
    hb = max(8, _next_pow2(-(-new_capacity // 2)))
    C = num_colors
    host = lambda t: t.detach().cpu().numpy()

    idx = np.nonzero(host(store.live))[0]
    a = host(store.body_a)[idx]
    b = host(store.body_b)[idx]
    color = np.minimum(host(store.color)[idx], C)
    feature = host(store.feature)[idx]
    imp_pen = host(store.imp_pen)[idx]
    imp_tx = host(store.imp_tx)[idx]
    imp_ty = host(store.imp_ty)[idx]
    imp_tw = host(store.imp_tw)[idx]
    active_prev = host(store.active_prev)[idx]

    # Place rows grouped by color into fresh pages.
    slots = np.full(len(idx), -1, np.int64)
    page_color = np.full(P, -1, np.int32)
    kept = np.zeros(len(idx), bool)
    next_slot = 0
    for j in np.argsort(color, kind="stable"):
        c = int(color[j])
        if next_slot % new_page == 0:
            if next_slot // new_page >= P:
                break
            page_color[next_slot // new_page] = c
        elif page_color[next_slot // new_page] != c:  # color change mid-page: next page
            next_slot = (next_slot // new_page + 1) * new_page
            if next_slot // new_page >= P:
                break
            page_color[next_slot // new_page] = c
        slots[j] = next_slot
        kept[j] = True
        next_slot += 1

    bucket = _hash_bucket(torch.from_numpy(a), torch.from_numpy(b), hb).numpy()
    body_a2 = np.zeros(new_capacity, np.int32)
    body_b2 = np.zeros(new_capacity, np.int32)
    live2 = np.zeros(new_capacity, bool)
    ap2 = np.zeros(new_capacity, bool)
    color2 = np.zeros(new_capacity, np.int32)
    hpos2 = np.zeros(new_capacity, np.int32)
    feature2 = np.full((new_capacity, 4), -1, np.int32)
    pen2 = np.zeros((new_capacity, 4), np.float32)
    tx2 = np.zeros(new_capacity, np.float32)
    ty2 = np.zeros(new_capacity, np.float32)
    tw2 = np.zeros(new_capacity, np.float32)
    used2 = np.zeros(n_bodies + 1, np.int32)
    jacv2 = np.zeros(n_bodies + 1, np.float32)
    ht2 = np.full((hb * LANES, 3), -1, np.int32)
    lane_fill = np.zeros(hb, np.int32)
    kind_np = np.asarray(kind) if kind is not None else np.ones(n_bodies, np.int32)
    for j in np.nonzero(kept)[0]:
        s, bi = int(slots[j]), int(bucket[j])
        ln = int(lane_fill[bi])
        if ln >= LANES:  # hash bucket full in the new table: drop (re-admitted later)
            continue
        lane_fill[bi] = ln + 1
        hp = bi * LANES + ln
        body_a2[s], body_b2[s], live2[s], ap2[s] = a[j], b[j], True, active_prev[j]
        color2[s], hpos2[s], feature2[s] = color[j], hp, feature[j]
        pen2[s], tx2[s], ty2[s], tw2[s] = imp_pen[j], imp_tx[j], imp_ty[j], imp_tw[j]
        ht2[hp] = (a[j], b[j], s)
        c = int(color[j])
        if c < C:
            if kind_np[a[j]] == KIND_DYNAMIC:
                used2[a[j]] |= 1 << c
            if kind_np[b[j]] == KIND_DYNAMIC:
                used2[b[j]] |= 1 << c
        else:
            jacv2[a[j]] += 1.0
            jacv2[b[j]] += 1.0

    dev = store.body_a.device
    t = lambda x: torch.from_numpy(x).to(dev)
    return PairStore(
        body_a=t(body_a2), body_b=t(body_b2), live=t(live2), active_prev=t(ap2),
        color=t(color2), hpos=t(hpos2), feature=t(feature2), imp_pen=t(pen2), imp_tx=t(tx2),
        imp_ty=t(ty2), imp_tw=t(tw2), used=t(used2), jacv=t(jacv2), ht=t(ht2),
        page_color=t(page_color),
    )
