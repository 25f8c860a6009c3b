"""Windowed-solve layout: Morton body permutation and segmented-window row grouping.

Counterpart of ``bepuphysics2_tpu/solver/windowing.py``, with the same integer outputs in
the same order. Kernel K2 (``ops/sweep.py::solve_substeps_contacts_win``) reads the
body state in this layout:

- **Body layout** (``body_layout``): every body slot sorted by the Morton code of its
  position, behind an APPENDIX that replicates up to ``GCOLS * 8`` non-dynamic bodies
  (grounds, kinematic drivers). Replication is sound because the solver never writes a
  non-dynamic velocity (zero inverse mass and inertia give zero deltas).
- **Segmented windows** (``row_windows``): each 256-row slice reaches its bodies through
  four 1,024-body segments of the layout. Narrow (color, lowest block) groups see
  [appendix, blk, blk+1, blk+2]; wide (blockA, blockB) groups, the Morton-seam
  crossings, see [appendix, blkA, blkB, appendix] and solve mass-split whatever their
  color. Groups pad to the slice size; padding rows are zero and add zero. Dead slices
  carry ``wseg[:, 0] == -1``. Wide demand beyond ``wide_cap`` raises the solver overflow
  flag and keeps those rows' warm-start impulses.

On the TPU the windows bound the one-hot routing cost; on the card they give K2 its row
contract, so the port can be held to the JAX package's own windowed result. Every size
here (``nch``, ``nblk``, ``b_n``, ``bp``, ``n_slices``) is a Python int derived from
capacities: nothing reads a device value to the host.
"""
from __future__ import annotations

import torch

from ..bodies import KIND_DYNAMIC, KIND_EMPTY
from ..collision.pairstore import _compact, _fdiv

GCOLS = 128  # appendix columns (GCOLS * 8 = 1024 replicated non-dynamic bodies)
BLK = 1024  # window block, in bodies; equals GCOLS * 8 (one segment)
SEGS = 4  # segments per slice window
WIN_BODIES = SEGS * BLK  # bodies addressable by one slice's window
I32 = torch.int32


def _morton10(x):
    """Spread the low 10 bits of x (int64) to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def body_layout(pos, kind):
    """Morton layout of all body slots plus the non-dynamic appendix.

    Returns a dict:
      pos_slot: (NP,) int32 — body slot at each layout position (NB = dead sentinel);
                NP = G + NB rounded so NP / 8 is a multiple of 128, plus 2 * BLK
                overhang so every window segment is in bounds.
      slot_pos: (NB,) int32 — spatial layout position of each slot.
      app_pos:  (NB,) int32 — appendix position of the slot, or -1.
      nch:      int — NP // 8.
      nblk:     int — Morton blocks of BLK bodies.
    """
    nb = kind.shape[0]
    dev = kind.device
    G = GCOLS * 8
    live = kind != KIND_EMPTY
    big = 3.0e38

    def rng(c):
        lo = torch.where(live, c, big).min()
        hi = torch.where(live, c, -big).max()
        return lo, torch.clamp_min(hi - lo, 1e-6)

    def q(c):
        lo, sp = rng(c)
        return torch.clamp((c - lo) / sp * 1023.0, 0.0, 1023.0).to(torch.int64)

    code = (_morton10(q(pos.x)) | (_morton10(q(pos.y)) << 1)
            | (_morton10(q(pos.z)) << 2)).to(I32)
    key = torch.where(live, code, 2**30)  # dead slots last
    order = torch.argsort(key, stable=True).to(I32)  # slot at spatial rank
    slot_sp = torch.empty(nb, dtype=I32, device=dev)
    slot_sp[order.long()] = torch.arange(nb, dtype=I32, device=dev)
    slot_pos = G + slot_sp

    nd = live & (kind != KIND_DYNAMIC)
    app_sel, _, _ = _compact(nd, G)  # slots replicated into the appendix (first G)
    app_pos = torch.full((nb + 1,), -1, dtype=I32, device=dev)
    app_pos[torch.clamp_max(app_sel, nb).long()] = torch.arange(G, dtype=I32, device=dev)
    app_pos = app_pos[:nb]

    nblk = -(-nb // BLK)
    np_need = G + (nblk + 2) * BLK
    nch = -(-(np_need // 8) // 128) * 128
    NP = nch * 8
    pos_slot = torch.cat([
        torch.where(app_sel < nb, app_sel, nb)[:G],
        order,
        torch.full((NP - G - nb,), nb, dtype=I32, device=dev),
    ])
    return dict(pos_slot=pos_slot, slot_pos=slot_pos, app_pos=app_pos, nch=nch, nblk=nblk)


def permute_rows(x, pos_slot):
    """Gather row-array x (NB, ...) into layout order (NP, ...), zero for sentinels."""
    xp = torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])
    return xp[pos_slot.long()]


def row_windows(lay, body_a, body_b, valid, color, num_colors: int, sb: int, wide_cap: int):
    """Group bank rows into segmented-window slices and build the padded windowed
    execution layout with its per-slice kernel metadata.

    Returns a dict:
      dest:   (B,) int32 — padded-layout row of each bank row (narrow region, wide
              region, or the sink ``bp`` for invalid and overflowed rows).
      b_n:    int — narrow region size (static bound).
      bp:     int — padded bank size (b_n + wide_cap).
      n_slices: int — bp // sb.
      wseg:   (n_slices, SEGS) int32 — window segment start columns (128-aligned);
              wseg[:, 0] == -1 marks a dead slice.
      rel_a, rel_b: (B,) int32 — window-relative body index of each side.
      wide:   (B,) bool — rows executing in the wide region (mass-split).
      wide_overflow: () bool — padded wide demand exceeded wide_cap.
      wide_demand: () int32 — padded wide demand in rows, before the cap.
      gid:    (n_slices,) int32 — the group each slice belongs to: in the narrow region
              its key ``color * nblk + block`` (Jacobi color C included), in the wide
              region ``(C + 1) * nblk + blockA * nblk + blockB``; -1 before a region's
              first group. Only live slices' ids mean anything. Not in the JAX dict: the
              port's K2 groups the slices of one color into waves by it.
    """
    nblk = lay["nblk"]
    G = GCOLS * 8
    C = num_colors
    B = body_a.shape[0]
    dev = body_a.device
    NGn = (C + 1) * nblk  # narrow groups: (color incl. Jacobi, lowest block)
    NGw = nblk * nblk  # wide groups: (blockA, blockB), color-free

    postab = torch.stack([lay["slot_pos"], lay["app_pos"]], -1)
    ga = postab[body_a.long()]
    gb = postab[body_b.long()]
    pa, pb = ga[:, 0], gb[:, 0]
    aa, ab = ga[:, 1], gb[:, 1]
    a_app = aa >= 0
    b_app = ab >= 0
    sp_a = pa - G
    sp_b = pb - G
    zero = torch.zeros_like(sp_a)
    lo_sp = torch.where(a_app, torch.where(b_app, zero, sp_b),
                        torch.where(b_app, sp_a, torch.minimum(sp_a, sp_b)))
    hi_sp = torch.where(a_app, torch.where(b_app, zero, sp_b),
                        torch.where(b_app, sp_a, torch.maximum(sp_a, sp_b)))
    narrow = valid & (hi_sp - lo_sp <= 2 * BLK)
    wide = valid & ~narrow
    wb = torch.clamp(_fdiv(lo_sp, BLK), 0, nblk - 1)
    blk_a = torch.clamp(_fdiv(sp_a, BLK), 0, nblk - 1)
    blk_b = torch.clamp(_fdiv(sp_b, BLK), 0, nblk - 1)
    col = torch.clamp(color, 0, C)
    key_n = col * nblk + wb  # meaningful where narrow
    key_w = blk_a * nblk + blk_b  # where wide

    # Padded grouping: counts -> slice-padded bases -> rank within group.
    ckey = torch.where(narrow, key_n, torch.where(wide, NGn + key_w, NGn + NGw)).to(I32)
    cnt_all = torch.zeros(NGn + NGw + 1, dtype=I32, device=dev).index_add_(
        0, ckey.long(), torch.ones(B, dtype=I32, device=dev))
    z1 = torch.zeros(1, dtype=I32, device=dev)
    cnt_n = cnt_all[:NGn]
    padded_n = -_fdiv(-cnt_n, sb) * sb
    base_n = torch.cat([z1, torch.cumsum(padded_n, 0).to(I32)])
    b_n = B + NGn * sb  # static worst case: every narrow group pays one partial slice

    cnt_w = cnt_all[NGn:NGn + NGw]
    padded_w = -_fdiv(-cnt_w, sb) * sb
    base_w = torch.cat([z1, torch.cumsum(padded_w, 0).to(I32)])
    wide_overflow = base_w[NGw] > wide_cap

    bp = b_n + wide_cap
    n_slices = bp // sb

    order = torch.argsort(ckey, stable=True)
    key_s = ckey[order]
    seg_start = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                           key_s[1:] != key_s[:-1]])
    idx = torch.arange(B, dtype=I32, device=dev)
    # Segment base by a running max: start indices increase along the sorted order.
    seg_base = torch.cummax(torch.where(seg_start, idx, 0), 0).values
    rank = torch.empty(B, dtype=I32, device=dev)
    rank[order] = idx - seg_base

    gw = base_w[torch.clamp_max(key_w, NGw - 1).long()]
    dest_n = base_n[torch.clamp_max(key_n, NGn - 1).long()] + rank
    dest_w = b_n + gw + rank
    w_kept = wide & (gw + rank < wide_cap)
    dest = torch.where(narrow, dest_n, torch.where(w_kept, dest_w, bp)).to(I32)

    # Per-slice window segments: each live group marks its start slice with its id;
    # the ids grow with the slice index, so a running max forward-fills them.
    n_sl_n = b_n // sb
    n_sl_w = wide_cap // sb

    def group_starts(bases, padded, n_sl):
        start = torch.where(padded > 0, _fdiv(bases, sb), n_sl)
        start = torch.where(start > n_sl, n_sl, start)  # past the region: dropped
        out = torch.full((n_sl + 1,), -1, dtype=I32, device=dev)
        out.scatter_reduce_(0, start.long(), torch.arange(bases.shape[0], dtype=I32, device=dev),
                            reduce="amax")
        return torch.cummax(out[:n_sl], 0).values

    sl_n = torch.arange(n_sl_n, dtype=I32, device=dev)
    gid_n = group_starts(base_n[:NGn], padded_n, n_sl_n)
    used_n = sl_n < _fdiv(base_n[NGn], sb)
    wb_sl = torch.remainder(gid_n.clamp_min(0), nblk)
    seg_n = torch.stack([
        torch.where(used_n & (gid_n >= 0), 0, -1).to(I32),
        GCOLS + wb_sl * GCOLS,
        GCOLS + (wb_sl + 1) * GCOLS,
        GCOLS + (wb_sl + 2) * GCOLS,
    ], 1)

    sl_w = torch.arange(n_sl_w, dtype=I32, device=dev)
    gid_w = group_starts(base_w[:NGw], padded_w, n_sl_w)
    used_w = sl_w < _fdiv(torch.clamp_max(base_w[NGw], wide_cap), sb)
    wa_sl = _fdiv(gid_w.clamp_min(0), nblk)
    wb2_sl = torch.remainder(gid_w.clamp_min(0), nblk)
    seg_w = torch.stack([
        torch.where(used_w & (gid_w >= 0), 0, -1).to(I32),
        GCOLS + wa_sl * GCOLS,
        GCOLS + wb2_sl * GCOLS,
        torch.zeros_like(wa_sl),  # never indexed by wide rows
    ], 1)
    wseg = torch.cat([seg_n, seg_w], 0).to(I32)

    # Window-relative body index per side: segment k covers [k * BLK, (k + 1) * BLK).
    rel_n_a = torch.where(a_app, aa, BLK + sp_a - wb * BLK)
    rel_n_b = torch.where(b_app, ab, BLK + sp_b - wb * BLK)
    rel_w_a = BLK + sp_a - blk_a * BLK
    rel_w_b = 2 * BLK + sp_b - blk_b * BLK
    gid = torch.cat([gid_n, torch.where(gid_w >= 0, NGn + gid_w, -1)]).to(I32)
    return dict(
        dest=dest, b_n=b_n, bp=bp, n_slices=n_slices, wseg=wseg, gid=gid,
        rel_a=torch.where(narrow, rel_n_a, rel_w_a).to(I32),
        rel_b=torch.where(narrow, rel_n_b, rel_w_b).to(I32),
        wide=wide, wide_overflow=wide_overflow, wide_demand=base_w[NGw],
    )


def scatter_rows(dest, bp: int, x, fill=0):
    """Scatter bank-row array x (B, ...) into the padded layout (BP, ...); rows sent to
    the sink ``bp`` are dropped."""
    out = torch.full((bp + 1,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    out[dest.long()] = x
    return out[:bp]

