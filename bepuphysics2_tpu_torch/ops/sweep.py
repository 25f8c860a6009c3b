"""K1, K2, K3 and K4, the contact-solve kernels, and their packed row contract.

Counterparts of ``solve_substeps_contacts``, ``solve_substeps_contacts_win``,
``contact_sweep`` and ``contact_sweep_win`` in ``bepuphysics2_tpu/ops/sweep.py``. K1 and
K2 run the whole substepped contact solve (incremental depth update,
pose/velocity/world-inertia block, warm start, velocity iterations) over slices taken in
page-execution order (K1) or over the windowed Morton layout of ``solver/windowing.py``
(K2). K3 runs one contact bank's velocity iterations within one substep of the general
(jointed or compound) solve, and K4 the same over the windowed layout. On a CUDA tensor
each wrapper launches its hand-written kernel (``csrc/substeps_contacts.cu``,
``csrc/substeps_contacts_win.cu``, ``csrc/contact_sweep.cu``,
``csrc/contact_sweep_win.cu``); on a CPU tensor it runs the plain PyTorch version written
below, which the kernel is held against.
The TPU layout tricks of the JAX kernels (bf16x3 one-hot routing, the transposed body
state, ``nch``) are not carried over: bodies are packed rows read by index.

Jacobi pages (color C) carry a mass-splitting scale per row side: the side's inertia is
multiplied by it at gather, and its velocity deltas are divided by it at scatter. Every
row of a slice reads the body state from before the slice.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constraints.contact import BodyVel
from ..integrator import (
    ANGULAR_CONSERVE_MOMENTUM,
    ANGULAR_CONSERVE_WITH_GYROSCOPIC,
    integrate_angular_conserve_momentum,
    integrate_angular_gyroscopic,
)
from ..utils.vec import Quat, Sym2, Sym3, Vec2, Vec3, build_orthonormal_basis, integrate_orientation
from . import build

# Argument types of the kernels' C entry points (pointers and the stream as c_void_p).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_K1_ARGS = [_P] * 11 + [_I] * 6 + [_F] * 7 + [_P]
_K2_ARGS = [_P] * 11 + [_I] * 6 + [_F] * 7 + [_P]
_K3_ARGS = [_P] * 7 + [_I] * 3 + [_F, _P]
_K4_ARGS = [_P] * 10 + [_I] * 3 + [_F, _P]

# --- packed contact prestep rows (component-major, (PS_ROWS, B)) -----------------------
PS_N = 0  # 0-2 normal xyz
PS_AX = 3  # 3-6 offset_a.x[k]
PS_AY = 7  # 7-10 offset_a.y[k]
PS_AZ = 11  # 11-14 offset_a.z[k]
PS_B = 15  # 15-17 offset_b xyz
PS_DEPTH = 18  # 18-21 depth[k]
PS_MASK = 22  # 22-25 contact mask[k] (0/1)
PS_FRICTION = 26
PS_ERRVEL = 27
PS_CFM = 28
PS_SOFT = 29
PS_MAXREC = 30
PS_VALID = 31
PS_ROWS = 32

IMP_ROWS = 8  # 0-3 pen[k], 4 tx, 5 ty, 6 twist, 7 pad


def pack_contact_prestep_cols(ps, springiness):
    """(B, PS_ROWS) column-stacked prestep (``.T`` is the kernel's (PS_ROWS, B) feed)."""
    err_vel, cfm, soft = springiness
    f = lambda m: m.float()
    cols = [
        ps.normal.x, ps.normal.y, ps.normal.z,
        *(ps.offset_a.x[:, k] for k in range(4)),
        *(ps.offset_a.y[:, k] for k in range(4)),
        *(ps.offset_a.z[:, k] for k in range(4)),
        ps.offset_b.x, ps.offset_b.y, ps.offset_b.z,
        *(ps.depth[:, k] for k in range(4)),
        *(f(ps.contact_mask[:, k]) for k in range(4)),
        ps.friction,
        err_vel, cfm, soft,
        ps.max_recovery_velocity,
        f(ps.valid),
    ]
    return torch.stack(cols, dim=-1)


def pack_contact_impulses_cols(imp):
    """(B, IMP_ROWS) column-stacked impulses."""
    z = torch.zeros_like(imp.twist)
    return torch.stack(
        [imp.penetration[:, 0], imp.penetration[:, 1], imp.penetration[:, 2],
         imp.penetration[:, 3], imp.tangent.x, imp.tangent.y, imp.twist, z],
        dim=-1,
    )


# --- per-row math over component rows ((rows, n) tensors) -----------------------------

def _friction_center_rows(ps, dep):
    """Depth-weighted manifold center. Returns (center_a, live_f list)."""
    live_f = [ps[PS_MASK + k] for k in range(4)]
    w_raw = [torch.where(dep[k] < 0.0, 0.0, 1.0) * live_f[k] for k in range(4)]
    wsum = w_raw[0] + w_raw[1] + w_raw[2] + w_raw[3]
    live_count = torch.clamp_min(live_f[0] + live_f[1] + live_f[2] + live_f[3], 1.0)
    fallback = wsum == 0.0
    w = [torch.where(fallback, live_f[k] / live_count, w_raw[k] / wsum.clamp_min(1.0))
         for k in range(4)]
    center_a = Vec3.zeros(ps[PS_N].shape, device=ps.device)
    for k in range(4):
        center_a = center_a + Vec3(ps[PS_AX + k], ps[PS_AY + k], ps[PS_AZ + k]) * w[k]
    return center_a, live_f


def _solve_contact_rows(ps, dep, imp, ia_im, ia_ii, ib_im, ib_ii, va, vb, inv_h):
    """One velocity iteration over a slice's rows (constraints/contact.py::solve math).
    Returns (new_imp rows, (dva_l, dva_a), (dvb_l, dvb_a))."""
    n = Vec3(ps[PS_N], ps[PS_N + 1], ps[PS_N + 2])
    err_vel, cfm, softness = ps[PS_ERRVEL], ps[PS_CFM], ps[PS_SOFT]
    valid = ps[PS_VALID] > 0.5
    off_b = Vec3(ps[PS_B], ps[PS_B + 1], ps[PS_B + 2])
    im_a, im_b = ia_im, ib_im
    zero = lambda: Vec3.zeros(n.x.shape, device=n.x.device)
    dva_l, dva_a, dvb_l, dvb_a = zero(), zero(), zero(), zero()
    pen_new = []
    pen_masked_sum = None
    pen_lever_sum = None
    center_a, live_f = _friction_center_rows(ps, dep)
    center_b = center_a - off_b
    for k in range(4):
        off_k = Vec3(ps[PS_AX + k], ps[PS_AY + k], ps[PS_AZ + k])
        off_bk = off_k - off_b
        ang_a = off_k.cross(n)
        ang_b = n.cross(off_bk)
        ang_a_im = ia_ii.transform(ang_a)
        ang_b_im = ib_ii.transform(ang_b)
        inv_eff = im_a + im_b + ang_a.dot(ang_a_im) + ang_b.dot(ang_b_im)
        eff = torch.where(inv_eff > 0.0, cfm / inv_eff.clamp_min(1e-30), 0.0)
        depth_k = dep[k]
        bias = torch.minimum(depth_k * inv_h, torch.minimum(depth_k * err_vel, ps[PS_MAXREC]))
        csv = ((va.linear + dva_l).dot(n) - (vb.linear + dvb_l).dot(n)
               + (va.angular + dva_a).dot(ang_a) + (vb.angular + dvb_a).dot(ang_b))
        acc_k = imp[k]
        negated_csi = acc_k * softness + (csv - bias) * eff
        new_acc = torch.clamp_min(acc_k - negated_csi, 0.0)
        live = (live_f[k] > 0.5) & valid
        new_acc = torch.where(live, new_acc, acc_k)
        corrective = torch.where(live, new_acc - acc_k, 0.0)
        pen_new.append(new_acc)
        lin = n * corrective
        dva_l = dva_l + lin * im_a
        dva_a = dva_a + ang_a_im * corrective
        dvb_l = dvb_l - lin * im_b
        dvb_a = dvb_a + ang_b_im * corrective
        pm = new_acc * live_f[k]
        pen_masked_sum = pm if pen_masked_sum is None else pen_masked_sum + pm
        pl_ = pm * (off_k - center_a).length()
        pen_lever_sum = pl_ if pen_lever_sum is None else pen_lever_sum + pl_

    t1, t2 = build_orthonormal_basis(n)
    ang_a1 = center_a.cross(t1)
    ang_a2 = center_a.cross(t2)
    ang_b1 = t1.cross(center_b)
    ang_b2 = t2.cross(center_b)
    ang_a1_im = ia_ii.transform(ang_a1)
    ang_a2_im = ia_ii.transform(ang_a2)
    ang_b1_im = ib_ii.transform(ang_b1)
    ang_b2_im = ib_ii.transform(ang_b2)
    imass = im_a + im_b
    m11 = imass + ang_a1.dot(ang_a1_im) + ang_b1.dot(ang_b1_im)
    m22 = imass + ang_a2.dot(ang_a2_im) + ang_b2.dot(ang_b2_im)
    m12 = ang_a1_im.dot(ang_a2) + ang_b1_im.dot(ang_b2)
    eff_t = Sym2(m11, m12, m22).inverse()

    va_l = va.linear + dva_l
    va_a = va.angular + dva_a
    vb_l = vb.linear + dvb_l
    vb_a = vb.angular + dvb_a
    csv1 = vb_l.dot(t1) - va_l.dot(t1) - va_a.dot(ang_a1) - vb_a.dot(ang_b1)
    csv2 = vb_l.dot(t2) - va_l.dot(t2) - va_a.dot(ang_a2) - vb_a.dot(ang_b2)
    csi = eff_t.transform(Vec2(csv1, csv2))

    contact_count = torch.clamp_min(live_f[0] + live_f[1] + live_f[2] + live_f[3], 1.0)
    premul_friction = ps[PS_FRICTION] / contact_count
    max_tangent = premul_friction * pen_masked_sum
    prev_tx, prev_ty = imp[4], imp[5]
    new_tx = prev_tx + csi.x
    new_ty = prev_ty + csi.y
    mag = torch.sqrt(new_tx * new_tx + new_ty * new_ty)
    sc = torch.clamp_max(max_tangent / mag.clamp_min(1e-16), 1.0)
    new_tx = torch.where(valid, new_tx * sc, prev_tx)
    new_ty = torch.where(valid, new_ty * sc, prev_ty)
    cx = new_tx - prev_tx
    cy = new_ty - prev_ty
    lin_t = t1 * cx + t2 * cy
    dva_l = dva_l + lin_t * im_a
    dva_a = dva_a + ang_a1_im * cx + ang_a2_im * cy
    dvb_l = dvb_l - lin_t * im_b
    dvb_a = dvb_a + ang_b1_im * cx + ang_b2_im * cy

    single = contact_count <= 1.0
    lever0 = dep[0].clamp_min(0.0)
    twist_cap = torch.where(
        single,
        premul_friction * pen_new[0] * live_f[0] * lever0,
        premul_friction * pen_lever_sum,
    )
    n_im_a = ia_ii.transform(n)
    n_im_b = ib_ii.transform(n)
    inv_eff_tw = n.dot(n_im_a) + n.dot(n_im_b)
    eff_tw = torch.where(inv_eff_tw == 0.0, 0.0, 1.0 / inv_eff_tw.clamp_min(1e-30))
    csv_tw = (va.angular + dva_a).dot(n) - (vb.angular + dvb_a).dot(n)
    csi_tw = -csv_tw * eff_tw
    prev_tw = imp[6]
    new_tw = torch.minimum(torch.maximum(prev_tw + csi_tw, -twist_cap), twist_cap)
    new_tw = torch.where(valid, new_tw, prev_tw)
    corr_tw = new_tw - prev_tw
    dva_a = dva_a + n_im_a * corr_tw
    dvb_a = dvb_a - n_im_b * corr_tw

    new_imp = pen_new + [new_tx, new_ty, new_tw, torch.zeros_like(new_tw)]
    return new_imp, (dva_l, dva_a), (dvb_l, dvb_a)


def _warm_start_rows(ps, dep, imp, ia_im, ia_ii, ib_im, ib_ii):
    """Warm-start velocity deltas (constraints/contact.py::warm_start math)."""
    n = Vec3(ps[PS_N], ps[PS_N + 1], ps[PS_N + 2])
    off_b = Vec3(ps[PS_B], ps[PS_B + 1], ps[PS_B + 2])
    valid = ps[PS_VALID] > 0.5
    center_a, live_f = _friction_center_rows(ps, dep)
    center_b = center_a - off_b
    t1, t2 = build_orthonormal_basis(n)
    tx = torch.where(valid, imp[4], 0.0)
    ty = torch.where(valid, imp[5], 0.0)
    tw = torch.where(valid, imp[6], 0.0)
    tangent_w = t1 * tx + t2 * ty
    lin = tangent_w
    ang_a = center_a.cross(tangent_w)
    ang_b = tangent_w.cross(center_b)
    vmul = torch.where(valid, 1.0, 0.0)
    for k in range(4):
        pen_k = imp[k] * live_f[k] * vmul
        off_k = Vec3(ps[PS_AX + k], ps[PS_AY + k], ps[PS_AZ + k])
        off_bk = off_k - off_b
        lin = lin + n * pen_k
        ang_a = ang_a + off_k.cross(n) * pen_k
        ang_b = ang_b + n.cross(off_bk) * pen_k
    ang_a = ang_a + n * tw
    ang_b = ang_b - n * tw
    return (lin * ia_im, ia_ii.transform(ang_a)), (lin * -1.0 * ib_im, ib_ii.transform(ang_b))


def _inc_depth_rows(ps, dep, va, vb, h):
    """Per-substep incremental depth update (contact.py::incremental_depth_update)."""
    n = Vec3(ps[PS_N], ps[PS_N + 1], ps[PS_N + 2])
    off_b = Vec3(ps[PS_B], ps[PS_B + 1], ps[PS_B + 2])
    out = []
    for k in range(4):
        off_k = Vec3(ps[PS_AX + k], ps[PS_AY + k], ps[PS_AZ + k])
        cv_a = va.angular.cross(off_k) + va.linear
        cv_b = vb.angular.cross(off_k - off_b) + vb.linear
        out.append(dep[k] - n.dot(cv_a - cv_b) * h)
    return torch.stack(out)


def _pose_vel_inertia_block(V, W, pos, orn, inv_mass, loc, gmask, imask, h, lin_scale,
                            ang_scale, gravity, angular_mode, s):
    """Substep boundary on every body: pose integration (s > 0), gravity and damping,
    world inverse inertia refresh. V (NB, 6) and W (NB, 7) update in place; returns
    (pos, orn)."""
    vel = Vec3(V[:, 0], V[:, 1], V[:, 2])
    omg = Vec3(V[:, 3], V[:, 4], V[:, 5])
    if s > 0:
        new_pos = (pos + vel * h).where(imask, pos)
        new_orn = integrate_orientation(orn, omg, h).where(imask, orn)
        if angular_mode == ANGULAR_CONSERVE_MOMENTUM:
            world_new = loc.rotation_sandwich(new_orn.to_matrix())
            omg = integrate_angular_conserve_momentum(orn, loc, world_new, omg).where(
                imask & gmask, omg)
        elif angular_mode == ANGULAR_CONSERVE_WITH_GYROSCOPIC:
            omg = integrate_angular_gyroscopic(new_orn, loc, omg, h).where(imask & gmask, omg)
        pos, orn = new_pos, new_orn
    gx, gy, gz = gravity
    new_vel = Vec3((vel.x + gx * h) * lin_scale, (vel.y + gy * h) * lin_scale,
                   (vel.z + gz * h) * lin_scale).where(gmask, vel)
    new_omg = (omg * ang_scale).where(gmask, omg)
    V.copy_(torch.stack([*new_vel, *new_omg], -1))
    w = loc.rotation_sandwich(orn.to_matrix())
    W.copy_(torch.stack([inv_mass, *w], -1))
    return pos, orn


def _vel_of(rows):
    return BodyVel(Vec3(rows[:, 0], rows[:, 1], rows[:, 2]),
                   Vec3(rows[:, 3], rows[:, 4], rows[:, 5]))


def _slice_pass(V, W, ps_t, imp, dep, idx, sc, sl, sb, solve, inv_h, it_t=None, dst=None,
                writes=None):
    """One slice of a plain walk, warm start (``solve`` False) or one velocity iteration:
    gather both sides from V (NB, 6) and W (NB, 7: inverse mass, world inverse inertia),
    compute every row, then ``index_add_`` the deltas divided by the side's scale into
    ``dst`` (V when None); with ``writes`` ((n_slices, 2 * sb) bool), only the entries it
    marks. ``idx`` and ``sc`` are (n_slices, 2 * sb); ``imp`` (8, B) is updated in place.
    With ``it_t`` (IT_ROWS, B) each row streams both sides' inertia, already mass-split,
    and W is unused."""
    cols = slice(sl * sb, (sl + 1) * sb)
    ia, ib = idx[sl, :sb], idx[sl, sb:]
    if it_t is None:
        wa = W[ia] * sc[sl, :sb, None]
        wb = W[ib] * sc[sl, sb:, None]
    else:
        wa, wb = it_t[0:7, cols].T, it_t[8:15, cols].T
    ia_im, ia_ii = wa[:, 0], Sym3(*wa[:, 1:].unbind(-1))
    ib_im, ib_ii = wb[:, 0], Sym3(*wb[:, 1:].unbind(-1))
    ps = ps_t[:, cols]
    if solve:
        new_imp, dva, dvb = _solve_contact_rows(
            ps, dep[:, cols], imp[:, cols], ia_im, ia_ii, ib_im, ib_ii,
            _vel_of(V[ia]), _vel_of(V[ib]), inv_h)
        imp[:, cols] = torch.stack(new_imp)
    else:
        dva, dvb = _warm_start_rows(ps, dep[:, cols], imp[:, cols], ia_im, ia_ii, ib_im, ib_ii)
    d = torch.cat([torch.stack([*dva[0], *dva[1]], -1),
                   torch.stack([*dvb[0], *dvb[1]], -1)]) / sc[sl][:, None]
    keep = slice(None) if writes is None else writes[sl]
    (V if dst is None else dst).index_add_(0, idx[sl][keep], d[keep])


def _walk_plain(v6, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask, ps_t, imp,
                dep, idx, sc, live, h, inv_h, lin_scale, ang_scale, *, sb, n_substeps,
                n_iters, angular_mode, gravity):
    """The grid's (substep, phase, slice) order as Python loops, shared by the plain K1
    and K2. ``idx`` and ``sc`` are (n_slices, 2 * sb): each slice's body rows and
    mass-split scales, A sides then B sides; ``live`` (n_slices,) marks the slices that
    run (the others move no body and keep their impulses and depths). ``imp`` (8, B) and
    ``dep`` (4, B) are updated in place. Returns (v6', pos', orn')."""
    V = v6.clone()
    W = torch.zeros((v6.shape[0], 7), dtype=torch.float32, device=v6.device)
    live_slices = [sl for sl, x in enumerate(live.tolist()) if x]
    live_col = live.repeat_interleave(sb)
    ia_all = idx[:, :sb].reshape(-1)
    ib_all = idx[:, sb:].reshape(-1)

    def slice_pass(sl, solve):
        _slice_pass(V, W, ps_t, imp, dep, idx, sc, sl, sb, solve, inv_h)

    for s in range(n_substeps):
        if s > 0:  # phase 0 reads velocities only: every live slice at once
            new_dep = _inc_depth_rows(ps_t, dep, _vel_of(V[ia_all]), _vel_of(V[ib_all]), h)
            dep.copy_(torch.where(live_col, new_dep, dep))
        pos, orn = _pose_vel_inertia_block(
            V, W, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask, h,
            lin_scale, ang_scale, gravity, angular_mode, s)
        for sl in live_slices:
            slice_pass(sl, False)
        for _ in range(n_iters):
            for sl in live_slices:
                slice_pass(sl, True)
    return V, pos, orn


def _solve_substeps_contacts_plain(v6, pos, orn, inv_mass, local_inv_inertia, grav_mask,
                                   integ_mask, ps_t, imp_t, idx2, scale, h, inv_h,
                                   lin_scale, ang_scale, *, sb, n_substeps, n_iters,
                                   angular_mode, gravity):
    """Plain PyTorch K1. Slices without a valid row are skipped, as the kernel skips
    them: their rows move no body and keep their impulses."""
    n_slices = ps_t.shape[1] // sb
    live = (ps_t[PS_VALID].reshape(n_slices, sb) > 0.5).any(dim=1)
    imp = imp_t.clone()
    dep = ps_t[PS_DEPTH:PS_DEPTH + 4].clone()
    V, pos, orn = _walk_plain(
        v6, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask, ps_t, imp, dep,
        idx2.reshape(n_slices, 2 * sb).long(), scale.reshape(n_slices, 2 * sb).float(), live,
        h, inv_h, lin_scale, ang_scale, sb=sb, n_substeps=n_substeps, n_iters=n_iters,
        angular_mode=angular_mode, gravity=gravity)
    return V, pos, orn, imp


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_bodies(v6, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask):
    nb, dev, f32 = v6.shape[0], v6.device, torch.float32
    _check("v6", v6, (nb, 6), f32, dev)
    for name, t in [("pos", pos), ("orn", orn), ("local_inv_inertia", local_inv_inertia)]:
        for c in t:
            _check(name, c, (nb,), f32, dev)
    _check("inv_mass", inv_mass, (nb,), f32, dev)
    _check("grav_mask", grav_mask, (nb,), torch.bool, dev)
    _check("integ_mask", integ_mask, (nb,), torch.bool, dev)


def _pack_bodies(v6, pos, orn, inv_mass, lii, grav_mask, integ_mask):
    """The kernels' packed body rows: bg (n, 16) velocity and world inertia, pose (n, 8),
    aux (n, 8) inverse mass, local inverse inertia and mask code."""
    bg = torch.zeros((v6.shape[0], 16), dtype=torch.float32, device=v6.device)
    bg[:, :6] = v6
    pose = torch.stack([*pos, *orn, torch.zeros_like(pos.x)], -1).contiguous()
    mcode = grav_mask.float() + 2.0 * integ_mask.float()
    aux = torch.stack([inv_mass, *lii, mcode], -1).contiguous()
    return bg, pose, aux


def _unpack_bodies(bg, pose):
    col = lambda t, c: t[:, c].contiguous()
    return (bg[:, :6].contiguous(), Vec3(col(pose, 0), col(pose, 1), col(pose, 2)),
            Quat(col(pose, 3), col(pose, 4), col(pose, 5), col(pose, 6)))


def _step_consts(angular_mode, gravity, h, inv_h, lin_scale, ang_scale):
    return [angular_mode, float(gravity[0]), float(gravity[1]), float(gravity[2]), float(h),
            float(inv_h), float(lin_scale), float(ang_scale)]


def writer_order(pos, writes):
    """(n_slices, 2 * sb) int32 order in which K1 and K4 sum a slice's deltas: each
    slice's entries (row sides) stably sorted by position, with the writing entries
    (``writes``, bool of the same shape) before all the others. Every run of one position
    among the writing entries then starts with a writing entry, and the kernels skip the
    runs that do not (waves.cuh sum_runs)."""
    key = pos.long() + torch.where(writes, 0, 1 << 40)
    return torch.sort(key, dim=1, stable=True).indices.to(torch.int32).contiguous()


def body_still(inv_mass, local_inv_inertia):
    """(n,) bool: the body takes no delta (zero inverse mass and inertia: static,
    kinematic), as K1 finds it from the world inertia of its body rows."""
    still = inv_mass == 0
    for c in local_inv_inertia:
        still = still & (c == 0)
    return still


def row_valid(ps_t, sb: int):
    """(n_slices, 2 * sb) bool: each entry's row is valid (``PS_VALID``), A sides then B
    sides per slice."""
    v = (ps_t[PS_VALID] > 0.5).reshape(-1, sb)
    return torch.cat([v, v], 1)


def _check_waves(name, waves, n_slices, dev):
    if waves is None:
        raise ValueError(f"the card's {name} needs the wave table: pass waves= "
                         "(ops.sweep.waves_by_key)")
    _check("waves", waves, (2 * n_slices + 2,), torch.int32, dev)


# What the cooperative kernels return when their shared memory (for slices of sb rows and
# a wave table of n slices) exceeds what one block may use (cudaErrorLaunchOutOfResources).
_SMEM_TOO_LARGE = 701


def _launch_failed(name, err, sb, n_slices):
    if err == _SMEM_TOO_LARGE:
        return ValueError(f"{name}: slices of {sb} rows and a wave table of {n_slices} slices "
                          "need more shared memory than one block of this card may use")
    return RuntimeError(f"{name} cooperative launch failed: CUDA error {err}")


def _check_aligned(name, **tensors):
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{label} is not 16-byte aligned: {name} copies it in 16-byte "
                             "pieces")


def _launch_kernel(v6, pos, orn, inv_mass, lii, grav_mask, integ_mask, ps_t, imp_t, idx2,
                   scale, h, inv_h, lin_scale, ang_scale, sb, n_substeps, n_iters,
                   angular_mode, gravity, waves):
    fn = build.bind("substeps_contacts", "substeps_contacts_launch", _K1_ARGS)
    nb = v6.shape[0]
    B = ps_t.shape[1]
    n_slices = B // sb
    dev = v6.device
    bg, pose, aux = _pack_bodies(v6, pos, orn, inv_mass, lii, grav_mask, integ_mask)
    imp = imp_t.clone()
    dep = torch.empty((4, B), dtype=torch.float32, device=dev)
    idx = idx2.view(n_slices, 2 * sb)
    writes = row_valid(ps_t, sb) & ~body_still(inv_mass, lii)[idx.long()]
    order = writer_order(idx, writes)
    slive = (ps_t[PS_VALID].view(n_slices, sb) > 0.5).any(dim=1).to(torch.int32)
    err = fn(bg.data_ptr(), pose.data_ptr(), aux.data_ptr(), ps_t.data_ptr(), imp.data_ptr(),
             dep.data_ptr(), idx2.data_ptr(), scale.data_ptr(), order.data_ptr(),
             slive.data_ptr(), waves.data_ptr(), nb, B, sb, n_substeps, n_iters,
             *_step_consts(angular_mode, gravity, h, inv_h, lin_scale, ang_scale),
             build.raw_stream(dev))
    if err != 0:
        raise _launch_failed("substeps_contacts", err, sb, n_slices)
    solve_substeps_contacts.launches += 1
    return (*_unpack_bodies(bg, pose), imp)


def solve_substeps_contacts(
    v6,  # (NB, 6)
    pos, orn,  # Vec3, Quat of (NB,)
    inv_mass,  # (NB,)
    local_inv_inertia,  # Sym3 of (NB,)
    grav_mask,  # (NB,) bool: dynamic & awake
    integ_mask,  # (NB,) bool: integrable
    ps_t,  # (PS_ROWS, B)
    imp_t,  # (IMP_ROWS, B)
    idx2,  # (n_slices*2SB,) int32
    scale,  # (n_slices*2SB,)
    h, inv_h, lin_scale, ang_scale,
    *,
    sb: int,
    n_substeps: int,
    n_iters: int,
    angular_mode: int,
    gravity: tuple,
    waves=None,  # (2 * n_slices + 2,) int32 wave table (waves_by_key)
):
    """Run the ENTIRE substepped contact solve. Returns (v6', pos', orn', imp_t').

    CUDA tensors go through the CUDA kernel (one cooperative launch over the card,
    counted in ``solve_substeps_contacts.launches``), which needs ``waves`` and runs each
    wave's slices at once; CPU tensors through the plain version, which walks the live
    slices in order and ignores ``waves``."""
    dev = v6.device
    B = ps_t.shape[1]
    nb = v6.shape[0]
    if sb <= 0 or B % sb:
        raise ValueError(f"bank of {B} rows does not split into slices of {sb}")
    f32 = torch.float32
    _check_bodies(v6, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask)
    _check("ps_t", ps_t, (PS_ROWS, B), f32, dev)
    _check("imp_t", imp_t, (IMP_ROWS, B), f32, dev)
    _check("idx2", idx2, (2 * B,), torch.int32, dev)
    _check("scale", scale, (2 * B,), f32, dev)
    args = (v6, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask, ps_t, imp_t,
            idx2, scale, h, inv_h, lin_scale, ang_scale)
    if dev.type == "cuda":
        _check_waves("K1", waves, B // sb, dev)
        _check_aligned("K1", ps_t=ps_t, idx2=idx2, scale=scale)
        return _launch_kernel(*args, sb, n_substeps, n_iters, angular_mode, gravity, waves)
    if dev.type != "cpu":
        raise ValueError(f"solve_substeps_contacts runs on cuda or cpu, not {dev.type}")
    return _solve_substeps_contacts_plain(
        *args, sb=sb, n_substeps=n_substeps, n_iters=n_iters, angular_mode=angular_mode,
        gravity=gravity)


solve_substeps_contacts.launches = 0


# --- K3: one bank's velocity iterations of one substep (the general path) -----------------

def _contact_sweep_plain(v6, inertia7, ps_t, imp_t, idx2, scale, inv_h, *, sb, n_iters):
    """Plain PyTorch K3: ``n_iters`` Gauss-Seidel sweeps over every slice of one contact
    bank, depths from the prestep rows. Slices without a valid row are skipped, as the
    kernel skips them: their rows move no body and keep their impulses."""
    n_slices = ps_t.shape[1] // sb
    live = (ps_t[PS_VALID].reshape(n_slices, sb) > 0.5).any(dim=1)
    live_slices = [sl for sl, x in enumerate(live.tolist()) if x]
    V = v6.clone()
    imp = imp_t.clone()
    dep = ps_t[PS_DEPTH:PS_DEPTH + 4]
    idx = idx2.reshape(n_slices, 2 * sb).long()
    sc = scale.reshape(n_slices, 2 * sb).float()
    for _ in range(n_iters):
        for sl in live_slices:
            _slice_pass(V, inertia7, ps_t, imp, dep, idx, sc, sl, sb, True, inv_h)
    return V, imp


def sweep_writes(ps_t, inertia7, idx2, sb: int):
    """(n_slices, 2 * sb) bool: the entries (row sides) K3 writes: a valid row's side
    whose body's ``inertia7`` row is not all zero."""
    idx = idx2.view(-1, 2 * sb).long()
    return row_valid(ps_t, sb) & (inertia7 != 0).any(1)[idx]


def _launch_sweep_kernel(v6, inertia7, ps_t, imp_t, idx2, scale, inv_h, sb, n_iters, order,
                         waves):
    fn = build.bind("contact_sweep", "contact_sweep_launch", _K3_ARGS)
    nb, B = v6.shape[0], ps_t.shape[1]
    bg = torch.zeros((nb, 16), dtype=torch.float32, device=v6.device)
    bg[:, :6] = v6
    bg[:, 8:15] = inertia7
    imp = imp_t.clone()
    if order is None:
        order = writer_order(idx2.view(-1, 2 * sb), sweep_writes(ps_t, inertia7, idx2, sb))
    err = fn(bg.data_ptr(), ps_t.data_ptr(), imp.data_ptr(), idx2.data_ptr(), scale.data_ptr(),
             order.data_ptr(), waves.data_ptr(), B, sb, n_iters, float(inv_h),
             build.raw_stream(v6.device))
    if err != 0:
        raise _launch_failed("contact_sweep", err, sb, B // sb)
    contact_sweep.launches += 1
    return bg[:, :6].contiguous(), imp


def contact_sweep(
    v6,  # (NB, 6) velocities
    inertia7,  # (NB, 7) inverse mass and world inverse inertia (xx yx yy zx zy zz)
    ps_t,  # (PS_ROWS, B) packed prestep, B = n_slices * sb
    imp_t,  # (IMP_ROWS, B) impulses
    idx2,  # (n_slices * 2sb,) int32 body row per side, per slice A sides then B sides
    scale,  # (n_slices * 2sb,) mass-split scale per side (1 outside the Jacobi slices)
    inv_h,
    *,
    sb: int,
    n_iters: int,
    order=None,  # writer_order of idx2 and sweep_writes, kept across launches
    waves=None,  # (2 * n_slices + 2,) int32 wave table (solver.solve.page_wave_table)
):
    """Run ``n_iters`` Gauss-Seidel sweeps over all slices of one contact bank within one
    substep: no integration, no warm start, depths from the prestep rows. Returns
    (v6', imp_t').

    CUDA tensors go through the CUDA kernel (one cooperative launch over the card,
    counted in ``contact_sweep.launches``), which needs ``waves`` and runs each wave's
    rows at once; CPU tensors through the plain version, which walks the live slices in
    order and ignores ``waves`` and ``order``."""
    dev = v6.device
    B = ps_t.shape[1]
    nb = v6.shape[0]
    if sb <= 0 or B % sb:
        raise ValueError(f"bank of {B} rows does not split into slices of {sb}")
    f32 = torch.float32
    _check("v6", v6, (nb, 6), f32, dev)
    _check("inertia7", inertia7, (nb, 7), f32, dev)
    _check("ps_t", ps_t, (PS_ROWS, B), f32, dev)
    _check("imp_t", imp_t, (IMP_ROWS, B), f32, dev)
    _check("idx2", idx2, (2 * B,), torch.int32, dev)
    _check("scale", scale, (2 * B,), f32, dev)
    if order is not None:
        _check("order", order, (B // sb, 2 * sb), torch.int32, dev)
    if dev.type == "cuda":
        _check_waves("K3", waves, B // sb, dev)
        _check_aligned("K3", ps_t=ps_t, idx2=idx2, scale=scale,
                       **({} if order is None else {"order": order}))
        return _launch_sweep_kernel(v6, inertia7, ps_t, imp_t, idx2, scale, inv_h, sb, n_iters,
                                    order, waves)
    if dev.type != "cpu":
        raise ValueError(f"contact_sweep runs on cuda or cpu, not {dev.type}")
    return _contact_sweep_plain(v6, inertia7, ps_t, imp_t, idx2, scale, inv_h, sb=sb,
                                n_iters=n_iters)


contact_sweep.launches = 0


def synthetic_sweep_bank(nb: int, sb: int, n_colored: int, n_jacobi: int, seed: int,
                         dt: float = 1.0 / 60.0, substeps: int = 4, slices_per_color=None):
    """A seeded K3 input, as numpy arrays: ``synthetic_bank``'s velocities, rows and
    structure (colored slices, ``slices_per_color`` of them per color when given, Jacobi
    slices with mass-split scales, padding) and its wave table ``waves``, with each body's
    ``inertia7`` row (inverse mass and world inverse inertia; zero for the static body
    0)."""
    bank = synthetic_bank(nb, sb, n_colored, n_jacobi, seed, dt=dt, substeps=substeps,
                          slices_per_color=slices_per_color)
    return dict(v6=bank["v6"], inertia7=_inertia7_np(bank), ps_t=bank["ps_t"],
                imp_t=bank["imp_t"], idx2=bank["idx2"], scale=bank["scale"], h=bank["h"],
                inv_h=bank["inv_h"], sb=sb, waves=bank["waves"])


def _inertia7_np(bank: dict):
    """(n, 7) f32 inverse mass and world inverse inertia (xx yx yy zx zy zz) of a bank's
    bodies, from their orientations and local inverse inertias."""
    x, y, z, w = bank["orn"].astype(np.float64).T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    lii = bank["local_inv_inertia"].astype(np.float64)
    loc = np.zeros((len(lii), 3, 3))
    for (r, c), k in {(0, 0): 0, (1, 0): 1, (1, 1): 2, (2, 0): 3, (2, 1): 4, (2, 2): 5}.items():
        loc[:, r, c] = loc[:, c, r] = lii[:, k]
    world = rot @ loc @ np.transpose(rot, (0, 2, 1))
    return np.concatenate([bank["inv_mass"][:, None].astype(np.float64),
                           world[:, [0, 1, 1, 2, 2, 2], [0, 0, 1, 0, 1, 2]]], 1).astype(np.float32)


def sweep_bank_args(bank: dict, device):
    """``contact_sweep`` positional arguments (v6 … inv_h) from a ``synthetic_sweep_bank``."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(bank["v6"]), t(bank["inertia7"]), t(bank["ps_t"]), t(bank["imp_t"]),
            t(bank["idx2"]), t(bank["scale"]), bank["inv_h"])


# --- K2: the windowed whole solve (above 8,192 bodies) -----------------------------------
# Bodies sit in the Morton layout of ``solver/windowing.py``; each 256-row slice names its
# bodies through four 1,024-body window segments.

IMPD_ROWS = 16  # K2 per-row state: 8 impulse rows + 4 depth rows + 4 unused
L = 8  # bodies per window column: a side's window-relative body is whi2 * L + wlo2
WSEG = 4  # window segments per slice
WSEG_COLS = 128  # window columns per segment (WSEG_COLS * L = 1,024 bodies)
NWIN = WSEG * WSEG_COLS  # window columns per slice


def window_positions(whi2, wlo2, wseg, sb: int):
    """(n_slices, 2 * sb) int64 layout position of every row side of a K2 bank: the side's
    window-relative body ``rel = whi2 * L + wlo2`` lies in segment ``rel >> 10`` at offset
    ``rel & 1023``, and that segment starts at body ``wseg[slice, seg] * L``."""
    n_slices = wseg.shape[0]
    rel = (whi2.long() * L + wlo2.long()).reshape(n_slices, 2 * sb)
    seg_start = wseg.long().clamp_min(0).gather(1, rel // (WSEG_COLS * L))
    return seg_start * L + rel % (WSEG_COLS * L)


def window_order(whi2, wlo2, wseg, sb: int):
    """(n_slices, 2 * sb) int32 stable sort of each slice's layout positions: the order in
    which K2 sums each position's deltas within a slice (K4 sums in ``writer_order``)."""
    order = torch.sort(window_positions(whi2, wlo2, wseg, sb), dim=1, stable=True).indices
    return order.to(torch.int32).contiguous()


def _solve_substeps_contacts_win_plain(v6p, pos_p, orn_p, inv_mass_p, local_inv_inertia_p,
                                       grav_mask_p, integ_mask_p, ps_t, imp_t, whi2, wlo2,
                                       scale, wseg, h, inv_h, lin_scale, ang_scale, *, sb,
                                       n_substeps, n_iters, angular_mode, gravity):
    """Plain PyTorch K2: K1's walk over the layout positions the windows name. Dead slices
    (``wseg[:, 0] < 0``) are skipped; depths live in rows 8-11 of the state."""
    n_slices = ps_t.shape[1] // sb
    imp = imp_t.clone()
    V, pos, orn = _walk_plain(
        v6p, pos_p, orn_p, inv_mass_p, local_inv_inertia_p, grav_mask_p, integ_mask_p, ps_t,
        imp[:IMP_ROWS], imp[IMP_ROWS:IMP_ROWS + 4], window_positions(whi2, wlo2, wseg, sb),
        scale.reshape(n_slices, 2 * sb).float(), wseg[:, 0] >= 0, h, inv_h, lin_scale,
        ang_scale, sb=sb, n_substeps=n_substeps, n_iters=n_iters, angular_mode=angular_mode,
        gravity=gravity)
    return V, pos, orn, imp


def waves_by_key(key, live):
    """The wave table of K1, K2 and K4 (``csrc/waves.cuh``), int32 of shape (2 * n + 2,)
    for n slices, by tensor ops alone (no host sync): element 0 is the number of waves W;
    elements 1 to n + 1 are each wave's first index into the live list, then the live
    count repeated; the rest is the live list, every live slice in ascending order, then
    -1. A wave is a maximal run of consecutive live slices of one key; a slice whose key
    is negative is a wave of its own. The caller gives a slice the key of its color c < C
    (offset per bank where several banks share a launch) when that color's slices touch
    pairwise distinct dynamic bodies, and -1 otherwise (Jacobi and wide slices)."""
    n = key.shape[0]
    dev = key.device
    sl = torch.arange(n, device=dev)
    key = torch.where(key >= 0, key.long(), -1 - sl)  # one key per uncolored slice
    order = torch.argsort((~live).to(torch.int32), stable=True)  # live slices first, in order
    n_live = live.sum()
    in_live = sl < n_live
    key_o = key[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), key_o[1:] != key_o[:-1]])
    start = in_live & first
    wave = torch.cumsum(start.long(), 0) - 1
    ptr = n_live.expand(n + 2).clone()  # slot n + 1 is a sink for the slices that start none
    ptr.scatter_(0, torch.where(start, wave, n + 1), sl)
    return torch.cat([start.sum().view(1), ptr[:n + 1],
                      torch.where(in_live, order, -1)]).to(torch.int32)


def wave_lists(waves):
    """The waves of a wave table (``waves_by_key``) as lists of slice indices, in walk
    order (reads the table to the host)."""
    w = waves.tolist()
    n_slices = (len(w) - 2) // 2
    ptr, live = w[1:n_slices + 2], w[n_slices + 2:]
    return [live[ptr[k]:ptr[k + 1]] for k in range(w[0])]


def wave_shape(waves):
    """(waves, color waves' sizes, tail slices, grid barriers) of one pass over a wave
    table: a wave of several slices is a color wave dealt over the grid, every other
    wave a tail slice walked in order on one block; each color wave and each run of tail
    slices ends at one grid barrier."""
    sizes = [len(w) for w in wave_lists(waves)]
    color = [k for k in sizes if k > 1]
    barriers = len(color) + sum(1 for i, k in enumerate(sizes)
                                if k == 1 and (i == 0 or sizes[i - 1] > 1))
    return len(sizes), color, len(sizes) - len(color), barriers


def wave_grid(name: str, sb: int, n_slices: int) -> int:
    """Blocks of a cooperative kernel's grid on the current card (``name`` the source of
    K1, K2, K3 or K4): the co-resident blocks per SM at its shared memory for ``n_slices``
    slices of ``sb`` rows, times the SMs."""
    fn = build.bind(name, f"{name}_grid", [_I, _I])
    grid = fn(sb, n_slices)
    if grid <= 0:
        raise RuntimeError(f"{name} cannot be co-scheduled on this card: CUDA error {-grid}")
    return grid


def _launch_win_kernel(v6p, pos_p, orn_p, inv_mass_p, lii_p, grav_mask_p, integ_mask_p, ps_t,
                       imp_t, whi2, wlo2, scale, wseg, h, inv_h, lin_scale, ang_scale, sb,
                       n_substeps, n_iters, angular_mode, gravity, waves):
    fn = build.bind("substeps_contacts_win", "substeps_contacts_win_launch", _K2_ARGS)
    bg, pose, aux = _pack_bodies(v6p, pos_p, orn_p, inv_mass_p, lii_p, grav_mask_p,
                                 integ_mask_p)
    imp = imp_t.clone()
    order = window_order(whi2, wlo2, wseg, sb)
    err = fn(bg.data_ptr(), pose.data_ptr(), aux.data_ptr(), ps_t.data_ptr(), imp.data_ptr(),
             whi2.data_ptr(), wlo2.data_ptr(), scale.data_ptr(), wseg.data_ptr(),
             order.data_ptr(), waves.data_ptr(), v6p.shape[0], ps_t.shape[1], sb, n_substeps,
             n_iters, *_step_consts(angular_mode, gravity, h, inv_h, lin_scale, ang_scale),
             build.raw_stream(v6p.device))
    if err != 0:
        raise _launch_failed("substeps_contacts_win", err, sb, ps_t.shape[1] // sb)
    solve_substeps_contacts_win.launches += 1
    return (*_unpack_bodies(bg, pose), imp)


def solve_substeps_contacts_win(
    v6p,  # (NP, 6) velocities in the windowed layout
    pos_p, orn_p,  # Vec3, Quat of (NP,)
    inv_mass_p,  # (NP,)
    local_inv_inertia_p,  # Sym3 of (NP,)
    grav_mask_p,  # (NP,) bool
    integ_mask_p,  # (NP,) bool
    ps_t,  # (PS_ROWS, B) windowed execution order
    imp_t,  # (IMPD_ROWS, B): rows 0-7 impulses, 8-11 initial depths
    whi2,  # (n_slices * 2SB,) int32 window-relative column of each side (A sides, B sides)
    wlo2,  # (n_slices * 2SB,) int32 lane
    scale,  # (n_slices * 2SB,) mass-split scales
    wseg,  # (n_slices, WSEG) int32 segment start columns; [:, 0] < 0 = dead slice
    h, inv_h, lin_scale, ang_scale,
    *,
    sb: int,
    n_substeps: int,
    n_iters: int,
    angular_mode: int,
    gravity: tuple,
    waves=None,  # (2 * n_slices + 2,) int32 wave table (solver.solve.wave_table)
):
    """The windowed variant of ``solve_substeps_contacts``: the ENTIRE substepped contact
    solve over the layout of ``solver/windowing.py``. Returns layout-order (v6', pos',
    orn', impd_t'); the impulses are rows 0-7 of impd_t'. The windows must lie inside the
    layout, as ``row_windows`` builds them.

    CUDA tensors go through the CUDA kernel (one cooperative launch over the card,
    counted in ``solve_substeps_contacts_win.launches``), which needs ``waves`` and runs
    each wave's slices at once; CPU tensors through the plain version, which walks the
    live slices in order and ignores ``waves``."""
    dev = v6p.device
    B = ps_t.shape[1]
    if sb <= 0 or B % sb:
        raise ValueError(f"bank of {B} rows does not split into slices of {sb}")
    f32 = torch.float32
    _check_bodies(v6p, pos_p, orn_p, inv_mass_p, local_inv_inertia_p, grav_mask_p,
                  integ_mask_p)
    _check("ps_t", ps_t, (PS_ROWS, B), f32, dev)
    _check("imp_t", imp_t, (IMPD_ROWS, B), f32, dev)
    _check("whi2", whi2, (2 * B,), torch.int32, dev)
    _check("wlo2", wlo2, (2 * B,), torch.int32, dev)
    _check("scale", scale, (2 * B,), f32, dev)
    _check("wseg", wseg, (B // sb, WSEG), torch.int32, dev)
    args = (v6p, pos_p, orn_p, inv_mass_p, local_inv_inertia_p, grav_mask_p, integ_mask_p,
            ps_t, imp_t, whi2, wlo2, scale, wseg, h, inv_h, lin_scale, ang_scale)
    if dev.type == "cuda":
        _check_waves("K2", waves, B // sb, dev)
        _check_aligned("K2", ps_t=ps_t, whi2=whi2, wlo2=wlo2, scale=scale, wseg=wseg)
        return _launch_win_kernel(*args, sb, n_substeps, n_iters, angular_mode, gravity, waves)
    if dev.type != "cpu":
        raise ValueError(f"solve_substeps_contacts_win runs on cuda or cpu, not {dev.type}")
    return _solve_substeps_contacts_win_plain(
        *args, sb=sb, n_substeps=n_substeps, n_iters=n_iters, angular_mode=angular_mode,
        gravity=gravity)


solve_substeps_contacts_win.launches = 0


# --- K4: one windowed bank's velocity iterations of one substep (the general path above
# 8,192 bodies) -----------------------------------------------------------------------

IT_ROWS = 16  # streamed inertia: A side im + world inverse inertia (6), 0 | B side, 0


def pack_inertia_rows(g2a, g2b):
    """(B, 7) mass-split inertia rows of the A and B sides (inverse mass, world inverse
    inertia xx yx yy zx zy zz) → K4's (IT_ROWS, B) streamed inertia."""
    z = torch.zeros_like(g2a[:, :1])
    return torch.cat([g2a, z, g2b, z], 1).T.contiguous()


def _contact_sweep_win_plain(v6p, it_t, ps_t, imp_t, whi2, wlo2, scale, wseg, inv_h, *, sb,
                             n_iters):
    """Plain PyTorch K4: K3's walk over the layout positions the windows name, with each
    side's inertia streamed from ``it_t`` (already mass-split: no scaling at gather),
    deltas divided by the scale. Dead slices (``wseg[:, 0] < 0``) are skipped; every other
    slice runs, as the JAX kernel runs it, and its invalid rows keep their impulses."""
    n_slices = ps_t.shape[1] // sb
    live_slices = [sl for sl, x in enumerate((wseg[:, 0] >= 0).tolist()) if x]
    V = v6p.clone()
    imp = imp_t.clone()
    dep = ps_t[PS_DEPTH:PS_DEPTH + 4]
    pos = window_positions(whi2, wlo2, wseg, sb)
    sc = scale.reshape(n_slices, 2 * sb)
    for _ in range(n_iters):
        for sl in live_slices:
            _slice_pass(V, None, ps_t, imp, dep, pos, sc, sl, sb, True, inv_h, it_t=it_t)
    return V, imp


def stream_writes(ps_t, it_t, sb: int):
    """(n_slices, 2 * sb) bool: the entries (row sides) K4 writes: a valid row's side
    whose streamed inertia is not all zero."""
    nz = lambda rows: (rows != 0).any(0).reshape(-1, sb)
    return row_valid(ps_t, sb) & torch.cat([nz(it_t[0:7]), nz(it_t[8:15])], 1)


def _launch_sweep_win_kernel(v6p, it_t, ps_t, imp_t, whi2, wlo2, scale, wseg, inv_h, sb,
                             n_iters, order, waves):
    fn = build.bind("contact_sweep_win", "contact_sweep_win_launch", _K4_ARGS)
    bg = torch.nn.functional.pad(v6p, (0, 2))
    imp = imp_t.clone()
    if order is None:
        order = writer_order(window_positions(whi2, wlo2, wseg, sb),
                             stream_writes(ps_t, it_t, sb))
    err = fn(bg.data_ptr(), it_t.data_ptr(), ps_t.data_ptr(), imp.data_ptr(), whi2.data_ptr(),
             wlo2.data_ptr(), scale.data_ptr(), wseg.data_ptr(), order.data_ptr(),
             waves.data_ptr(), ps_t.shape[1], sb, n_iters, float(inv_h),
             build.raw_stream(v6p.device))
    if err != 0:
        raise _launch_failed("contact_sweep_win", err, sb, ps_t.shape[1] // sb)
    contact_sweep_win.launches += 1
    return bg[:, :6].contiguous(), imp


def contact_sweep_win(
    v6p,  # (NP, 6) velocities in the windowed layout (NP = lay["nch"] * 8)
    it_t,  # (IT_ROWS, B) mass-split inertia of both sides of every row
    ps_t,  # (PS_ROWS, B) packed prestep in windowed execution order, B = n_slices * sb
    imp_t,  # (IMP_ROWS, B) impulses
    whi2,  # (n_slices * 2sb,) int32 window-relative column of each side (A sides, B sides)
    wlo2,  # (n_slices * 2sb,) int32 lane
    scale,  # (n_slices * 2sb,) mass-split scale per side
    wseg,  # (n_slices, WSEG) int32 segment start columns; [:, 0] < 0 = dead slice
    inv_h,
    *,
    sb: int,
    n_iters: int,
    order=None,  # writer_order of the positions and stream_writes, kept across launches
    waves=None,  # (2 * n_slices + 2,) int32 wave table (solver.solve.wave_table)
):
    """The windowed variant of ``contact_sweep``: ``n_iters`` Gauss-Seidel sweeps over the
    slices of one bank in the layout of ``solver/windowing.py`` within one substep, depths
    from the prestep rows. Returns layout-order (v6p', imp_t').

    CUDA tensors go through the CUDA kernel (one cooperative launch over the card,
    counted in ``contact_sweep_win.launches``), which needs ``waves`` and runs each wave's
    slices at once; CPU tensors through the plain version, which walks the live slices in
    order and ignores ``waves`` and ``order``."""
    dev = v6p.device
    B = ps_t.shape[1]
    if sb <= 0 or B % sb:
        raise ValueError(f"bank of {B} rows does not split into slices of {sb}")
    f32 = torch.float32
    _check("v6p", v6p, (v6p.shape[0], 6), f32, dev)
    _check("it_t", it_t, (IT_ROWS, B), f32, dev)
    _check("ps_t", ps_t, (PS_ROWS, B), f32, dev)
    _check("imp_t", imp_t, (IMP_ROWS, B), f32, dev)
    _check("whi2", whi2, (2 * B,), torch.int32, dev)
    _check("wlo2", wlo2, (2 * B,), torch.int32, dev)
    _check("scale", scale, (2 * B,), f32, dev)
    _check("wseg", wseg, (B // sb, WSEG), torch.int32, dev)
    if order is not None:
        _check("order", order, (B // sb, 2 * sb), torch.int32, dev)
    args = (v6p, it_t, ps_t, imp_t, whi2, wlo2, scale, wseg, inv_h)
    if dev.type == "cuda":
        _check_waves("K4", waves, B // sb, dev)
        _check_aligned("K4", it_t=it_t, ps_t=ps_t, whi2=whi2, wlo2=wlo2, scale=scale, wseg=wseg,
                       **({} if order is None else {"order": order}))
        return _launch_sweep_win_kernel(*args, sb, n_iters, order, waves)
    if dev.type != "cpu":
        raise ValueError(f"contact_sweep_win runs on cuda or cpu, not {dev.type}")
    return _contact_sweep_win_plain(*args, sb=sb, n_iters=n_iters)


contact_sweep_win.launches = 0


def synthetic_bank(nb: int, sb: int, n_colored: int, n_jacobi: int, seed: int,
                   dt: float = 1.0 / 60.0, substeps: int = 4, slices_per_color=None):
    """A seeded K1 input with the structure the solver hands it, as numpy arrays: body 0
    is a static ground, colored slices touch each dynamic body at most once (statics may
    repeat), the trailing Jacobi slices share bodies and carry each side's mass-split
    valence as its scale, and partly filled slices end in padding rows (valid 0, scale
    1). Used to hold the kernel against its plain version and the JAX kernel.

    By default every colored slice is a color of its own (a fresh permutation of the
    bodies each), so consecutive colored slices share bodies. With ``slices_per_color``
    (a list of slice counts summing to ``n_colored``) each color draws one permutation and
    splits it over its slices, as a page stream of that many pages per color: the slices
    of one color touch pairwise distinct dynamic bodies. ``waves`` is K1's wave table
    (``waves_by_key``) over either structure."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n_slices = n_colored + n_jacobi
    B = n_slices * sb
    dyn = np.arange(1, nb)
    pos = np.stack([rng.uniform(-20, 20, nb), rng.uniform(0, 10, nb),
                    rng.uniform(-20, 20, nb)], -1).astype(f32)
    q = rng.normal(size=(nb, 4))
    orn = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(f32)
    v6 = rng.uniform(-0.5, 0.5, (nb, 6)).astype(f32)
    inv_mass = rng.uniform(0.5, 2.0, nb).astype(f32)
    lii = np.zeros((nb, 6), f32)
    lii[:, [0, 2, 5]] = rng.uniform(1.0, 4.0, (nb, 3))
    lii[:, [1, 3, 4]] = rng.uniform(-0.2, 0.2, (nb, 3))
    inv_mass[0] = 0.0
    lii[0] = 0.0
    v6[0] = 0.0
    grav = np.ones(nb, bool)
    grav[0] = False
    grav[rng.uniform(size=nb) < 0.05] = False  # a few sleeping bodies
    integ = grav.copy()

    a = np.zeros((n_slices, sb), np.int64)
    b = np.zeros((n_slices, sb), np.int64)
    valid = np.zeros((n_slices, sb), bool)
    counts = [1] * n_colored if slices_per_color is None else list(slices_per_color)
    if sum(counts) != n_colored:
        raise ValueError(f"slices_per_color {counts} does not sum to {n_colored}")
    key = np.full(n_slices, -1, np.int64)
    s = 0
    for color, k in enumerate(counts):
        perm = rng.permutation(dyn)
        for part in np.array_split(perm, k):
            n_pair = min(sb // 2, len(part) // 4)
            n_ground = min(sb - n_pair, len(part) - 2 * n_pair)
            a[s, :n_pair], b[s, :n_pair] = part[:n_pair], part[n_pair:2 * n_pair]
            a[s, n_pair:n_pair + n_ground] = part[2 * n_pair:2 * n_pair + n_ground]
            valid[s, :n_pair + n_ground] = True
            key[s] = color
            s += 1
    hot = rng.choice(dyn, size=max(2, len(dyn) // 3), replace=False)
    for s in range(n_colored, n_slices):
        n_rows = sb // 2
        a[s, :n_rows] = rng.choice(hot, n_rows)
        b[s, :n_rows] = np.where(rng.uniform(size=n_rows) < 0.2, 0, rng.choice(dyn, n_rows))
        same = a[s] == b[s]
        b[s, same] = 0
        valid[s, :n_rows] = True
    a, b, valid = a.reshape(-1), b.reshape(-1), valid.reshape(-1)
    jac = np.zeros(B, bool)
    jac[n_colored * sb:] = valid[n_colored * sb:]
    valence = np.maximum(np.bincount(a[jac], minlength=nb) + np.bincount(b[jac], minlength=nb), 1)
    sa = np.where(jac, valence[a], 1).astype(f32)
    sbs = np.where(jac, valence[b], 1).astype(f32)

    h = f32(dt) / f32(substeps)
    w = f32(30.0 * 2 * np.pi)
    extra = f32(1.0) / (w * h * (w * h + f32(2.0)))
    cfm = f32(1.0) / (f32(1.0) + extra)
    normal = rng.normal(size=(B, 3)) + np.array([0.0, 3.0, 0.0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    mask = rng.uniform(size=(B, 4)) < 0.7
    mask[:, 0] = True
    ps = np.zeros((PS_ROWS, B), f32)
    ps[PS_N:PS_N + 3] = normal.T
    ps[PS_AX:PS_AX + 12] = rng.uniform(-0.5, 0.5, (12, B))
    ps[PS_B:PS_B + 3] = (pos[b] - pos[a]).T
    ps[PS_DEPTH:PS_DEPTH + 4] = rng.uniform(-0.01, 0.01, (4, B))
    ps[PS_MASK:PS_MASK + 4] = mask.T
    ps[PS_FRICTION] = rng.uniform(0.5, 1.0, B)
    ps[PS_ERRVEL] = w / (w * h + f32(2.0))
    ps[PS_CFM] = cfm
    ps[PS_SOFT] = extra * cfm
    ps[PS_MAXREC] = 2.0
    ps[PS_VALID] = valid
    ps[:, ~valid] = 0.0
    imp = np.zeros((IMP_ROWS, B), f32)
    imp[0:4] = rng.uniform(0.0, 0.02, (4, B)) * mask.T
    imp[4:7] = rng.uniform(-0.02, 0.02, (3, B))
    imp[:, ~valid] = 0.0

    slice_major = lambda xa, xb: np.concatenate(
        [xa.reshape(n_slices, sb), xb.reshape(n_slices, sb)], 1).reshape(-1)
    live = torch.from_numpy(valid.reshape(n_slices, sb).any(1))
    return dict(
        v6=v6, pos=pos, orn=orn, inv_mass=inv_mass, local_inv_inertia=lii,
        grav_mask=grav, integ_mask=integ, ps_t=ps, imp_t=imp,
        idx2=slice_major(a, b).astype(np.int32), scale=slice_major(sa, sbs),
        h=float(h), inv_h=float(f32(substeps) / f32(dt)), sb=sb, n_substeps=substeps,
        waves=waves_by_key(torch.from_numpy(key), live).numpy(),
    )


def bank_args(bank: dict, device):
    """``solve_substeps_contacts`` positional arguments (v6 … ang_scale) from a
    ``synthetic_bank`` on ``device``."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    cols = lambda x: [t(x[:, j]) for j in range(x.shape[1])]
    return (t(bank["v6"]), Vec3(*cols(bank["pos"])), Quat(*cols(bank["orn"])),
            t(bank["inv_mass"]), Sym3(*cols(bank["local_inv_inertia"])),
            t(bank["grav_mask"]), t(bank["integ_mask"]), t(bank["ps_t"]), t(bank["imp_t"]),
            t(bank["idx2"]), t(bank["scale"]), bank["h"], bank["inv_h"], 1.0, 1.0)


def synthetic_win_bank(nb: int, n_rows: int, num_colors: int, seed: int,
                       dt: float = 1.0 / 60.0, substeps: int = 4, wide_frac: float = 0.0,
                       wide_cap_rows: int = 0, fill: float = 0.9):
    """A seeded K2 input with the structure the windowed solve hands it, as numpy arrays.
    Body 0 is a static ground under a jittered cubic lattice of the other bodies, about 2%
    of which are static and 5% asleep. Rows join lattice neighbours (along the axes and
    the face diagonals) and the bottom layer to the ground, ``wide_frac`` of them instead
    join random far bodies, and they fill at most ``fill`` of the ``n_rows`` slots,
    scattered among invalid ones. Rows take the lowest color free
    at both dynamic ends (the Jacobi color ``num_colors`` when none is). The bank then goes
    through the port's own windowed layout (``solver.solve.win_pack``), so the result is
    what K2 receives: its positional arguments in layout order, its wave table
    ``waves``, plus ``sb``, ``n_substeps``, ``nb``, ``bp``, ``live_slices`` and
    ``wide_rows``, and K4's streamed
    inertia ``it_t``: each row side's body inverse mass and world inverse inertia times
    the side's scale (padding rows read layout position 0 at scale 1)."""
    from ..bodies import KIND_DYNAMIC, KIND_STATIC
    from ..solver.solve import SB_WIN, _round_up, win_pack

    rng = np.random.default_rng(seed)
    f32 = np.float32
    C = num_colors
    n_lat = nb - 1
    side = max(1, int(np.ceil(n_lat ** (1 / 3) - 1e-9)))
    ijk = np.stack(np.unravel_index(np.arange(n_lat), (side, side, side)), -1)
    pos = np.zeros((nb, 3))
    pos[0] = (0.0, -0.5, 0.0)
    pos[1:] = ijk - np.array([side / 2, -0.5, side / 2]) + rng.uniform(-0.05, 0.05, (n_lat, 3))
    pos = pos.astype(f32)
    kind = np.full(nb, KIND_DYNAMIC, np.int32)
    kind[0] = KIND_STATIC
    kind[1 + rng.choice(n_lat, max(1, n_lat // 50), replace=False)] = KIND_STATIC
    dyn = kind == KIND_DYNAMIC

    slot_of = np.full((side, side, side), -1, np.int64)
    slot_of[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = np.arange(1, nb)
    pairs = []
    steps = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1),
             (0, 1, 1), (0, 1, -1)]
    for step in np.array(steps):
        nxt = ijk + step
        ok = ((nxt >= 0) & (nxt < side)).all(1)
        b = slot_of[nxt[ok, 0], nxt[ok, 1], nxt[ok, 2]]
        a = np.arange(1, nb)[ok]
        pairs.append(np.stack([a[b >= 0], b[b >= 0]], -1))
    bottom = np.arange(1, nb)[ijk[:, 1] == 0]
    pairs.append(np.stack([np.zeros_like(bottom), bottom], -1))
    pairs = np.concatenate(pairs)
    pairs = pairs[rng.permutation(len(pairs))]
    n_valid = min(len(pairs), int(fill * n_rows))
    pairs = pairs[:n_valid]
    far = rng.uniform(size=n_valid) < wide_frac
    dyn_slots = np.nonzero(dyn)[0]
    pairs[far] = rng.choice(dyn_slots, (int(far.sum()), 2))
    pairs = pairs[(pairs[:, 0] != pairs[:, 1]) & (dyn[pairs[:, 0]] | dyn[pairs[:, 1]])]
    n_valid = len(pairs)

    color = np.zeros(n_valid, np.int32)
    used = np.zeros(nb, np.int64)
    for r, (a, b) in enumerate(pairs):
        taken = (used[a] if dyn[a] else 0) | (used[b] if dyn[b] else 0)
        c = next((c for c in range(C) if not taken >> c & 1), C)
        color[r] = c
        if c < C:
            used[a] |= dyn[a] << c
            used[b] |= dyn[b] << c
    slots = rng.choice(n_rows, n_valid, replace=False)
    body_a = np.zeros(n_rows, np.int32)
    body_b = np.zeros(n_rows, np.int32)
    col = np.zeros(n_rows, np.int32)
    valid = np.zeros(n_rows, bool)
    body_a[slots], body_b[slots], col[slots], valid[slots] = pairs[:, 0], pairs[:, 1], color, True
    jac = valid & (col == C)
    jacv = (np.bincount(body_a[jac], minlength=nb + 1)
            + np.bincount(body_b[jac], minlength=nb + 1)).astype(f32)

    h = f32(dt) / f32(substeps)
    w = f32(30.0 * 2 * np.pi)
    extra = f32(1.0) / (w * h * (w * h + f32(2.0)))
    cfm = f32(1.0) / (f32(1.0) + extra)
    normal = rng.normal(size=(n_rows, 3)) + np.array([0.0, 3.0, 0.0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    mask = rng.uniform(size=(n_rows, 4)) < 0.7
    mask[:, 0] = True
    M = np.zeros((n_rows, PS_ROWS + IMP_ROWS), f32)
    M[:, PS_N:PS_N + 3] = normal
    M[:, PS_AX:PS_AX + 12] = rng.uniform(-0.5, 0.5, (n_rows, 12))
    M[:, PS_B:PS_B + 3] = pos[body_b] - pos[body_a]
    M[:, PS_DEPTH:PS_DEPTH + 4] = rng.uniform(-0.01, 0.01, (n_rows, 4))
    M[:, PS_MASK:PS_MASK + 4] = mask
    M[:, PS_FRICTION] = rng.uniform(0.5, 1.0, n_rows)
    M[:, PS_ERRVEL] = w / (w * h + f32(2.0))
    M[:, PS_CFM] = cfm
    M[:, PS_SOFT] = extra * cfm
    M[:, PS_MAXREC] = 2.0
    M[:, PS_VALID] = valid
    M[:, PS_ROWS:PS_ROWS + 4] = rng.uniform(0.0, 0.02, (n_rows, 4)) * mask
    M[:, PS_ROWS + 4:PS_ROWS + 7] = rng.uniform(-0.02, 0.02, (n_rows, 3))
    M[~valid] = 0.0

    q = rng.normal(size=(nb, 4))
    orn = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(f32)
    v6 = np.where(dyn[:, None], rng.uniform(-0.5, 0.5, (nb, 6)), 0.0).astype(f32)
    inv_mass = np.where(dyn, rng.uniform(0.5, 2.0, nb), 0.0).astype(f32)
    lii = np.zeros((nb, 6), f32)
    lii[:, [0, 2, 5]] = rng.uniform(1.0, 4.0, (nb, 3))
    lii[:, [1, 3, 4]] = rng.uniform(-0.2, 0.2, (nb, 3))
    lii[~dyn] = 0.0
    grav = dyn & (rng.uniform(size=nb) >= 0.05)

    t = torch.from_numpy
    wide_cap = max(SB_WIN, _round_up(wide_cap_rows or n_rows // 8, SB_WIN))
    wp = win_pack(Vec3(*(t(pos[:, k].copy()) for k in range(3))), t(kind), t(body_a),
                  t(body_b), t(valid), t(col), t(jacv), t(M), C, wide_cap)
    pos_slot = wp["lay"]["pos_slot"].long()
    perm = lambda x: np.concatenate([x, np.zeros((1,) + x.shape[1:], x.dtype)])[pos_slot]
    it7 = perm(_inertia7_np(dict(orn=orn, local_inv_inertia=lii, inv_mass=inv_mass)))
    nsl = wp["wseg"].shape[0]
    side = window_positions(wp["whi2"], wp["wlo2"], wp["wseg"], SB_WIN).numpy()
    it2 = it7[side] * wp["scale"].numpy().reshape(nsl, 2 * SB_WIN)[:, :, None]
    it_t = pack_inertia_rows(torch.from_numpy(it2[:, :SB_WIN].reshape(-1, 7)),
                             torch.from_numpy(it2[:, SB_WIN:].reshape(-1, 7))).numpy()
    return dict(
        v6=perm(v6), pos=perm(pos), orn=perm(orn), inv_mass=perm(inv_mass),
        local_inv_inertia=perm(lii), grav_mask=perm(grav), integ_mask=perm(grav),
        ps_t=wp["ps_t"].numpy(), imp_t=wp["imp_t"].numpy(), whi2=wp["whi2"].numpy(),
        wlo2=wp["wlo2"].numpy(), scale=wp["scale"].numpy(), wseg=wp["wseg"].numpy(),
        waves=wp["waves"].numpy(), it_t=it_t,
        h=float(h), inv_h=float(f32(substeps) / f32(dt)), sb=SB_WIN, n_substeps=substeps,
        nb=nb, bp=wp["rw"]["bp"], live_slices=int((wp["wseg"][:, 0] >= 0).sum()),
        wide_rows=int(wp["rw"]["wide"].sum()),
    )


def win_bank_args(bank: dict, device):
    """``solve_substeps_contacts_win`` positional arguments (v6p … ang_scale) from a
    ``synthetic_win_bank`` on ``device``; its ``waves`` keyword is ``bank["waves"]``."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    cols = lambda x: [t(x[:, j]) for j in range(x.shape[1])]
    return (t(bank["v6"]), Vec3(*cols(bank["pos"])), Quat(*cols(bank["orn"])),
            t(bank["inv_mass"]), Sym3(*cols(bank["local_inv_inertia"])),
            t(bank["grav_mask"]), t(bank["integ_mask"]), t(bank["ps_t"]), t(bank["imp_t"]),
            t(bank["whi2"]), t(bank["wlo2"]), t(bank["scale"]), t(bank["wseg"]),
            bank["h"], bank["inv_h"], 1.0, 1.0)


def sweep_win_bank_args(bank: dict, device):
    """``contact_sweep_win`` positional arguments (v6p … inv_h) from a
    ``synthetic_win_bank`` on ``device``: its impulse rows, depths from the prestep."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(bank["v6"]), t(bank["it_t"]), t(bank["ps_t"]), t(bank["imp_t"][:IMP_ROWS]),
            t(bank["whi2"]), t(bank["wlo2"]), t(bank["scale"]), t(bank["wseg"]),
            bank["inv_h"])
