"""K1, the whole-solve contact kernel, and its packed row contract.

Counterpart of ``solve_substeps_contacts`` in ``bepuphysics2_tpu/ops/sweep.py``: the whole
substepped contact solve (incremental depth update, pose/velocity/world-inertia block,
warm start, velocity iterations) over slices taken in page-execution order. On a CUDA
tensor the wrapper launches the hand-written kernel ``csrc/substeps_contacts.cu``; on a
CPU tensor it runs the plain PyTorch version written below, which the kernel is held
against. The TPU layout tricks of the JAX kernel (bf16x3 one-hot routing, the transposed
body state, ``nch``) are not carried over: bodies are packed rows read by index.

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


def _solve_substeps_contacts_plain(v6, pos, orn, inv_mass, local_inv_inertia, grav_mask,
                                   integ_mask, ps_t, imp_t, idx2, scale, h, inv_h,
                                   lin_scale, ang_scale, *, sb, n_substeps, n_iters,
                                   angular_mode, gravity):
    """Plain PyTorch K1: the grid's (substep, phase, slice) order as Python loops. Per
    slice it gathers, computes every row, then applies ``index_add_`` of the deltas.
    Slices without a valid row are skipped, as the kernel skips them: their rows move
    no body and keep their impulses."""
    B = ps_t.shape[1]
    n_slices = B // sb
    live = (ps_t[PS_VALID].reshape(n_slices, sb) > 0.5).any(dim=1).tolist()
    live_slices = [sl for sl in range(n_slices) if live[sl]]
    V = v6.clone()
    W = torch.zeros((v6.shape[0], 7), dtype=torch.float32, device=v6.device)
    IMP = imp_t.clone()
    idx = idx2.reshape(n_slices, 2 * sb).long()
    sc = scale.reshape(n_slices, 2 * sb).float()
    ia_all = idx[:, :sb].reshape(-1)
    ib_all = idx[:, sb:].reshape(-1)
    dep = ps_t[PS_DEPTH:PS_DEPTH + 4].clone()

    def vel_of(rows):
        return BodyVel(Vec3(rows[:, 0], rows[:, 1], rows[:, 2]),
                       Vec3(rows[:, 3], rows[:, 4], rows[:, 5]))

    def slice_pass(sl, solve):
        cols = slice(sl * sb, (sl + 1) * sb)
        ia, ib = idx[sl, :sb], idx[sl, sb:]
        sa, sbs = sc[sl, :sb], sc[sl, sb:]
        wa = W[ia] * sa[:, None]
        wb = W[ib] * sbs[:, None]
        ia_im, ia_ii = wa[:, 0], Sym3(*wa[:, 1:].unbind(-1))
        ib_im, ib_ii = wb[:, 0], Sym3(*wb[:, 1:].unbind(-1))
        ps = ps_t[:, cols]
        imp = IMP[:, cols]
        if solve:
            new_imp, dva, dvb = _solve_contact_rows(
                ps, dep[:, cols], imp, ia_im, ia_ii, ib_im, ib_ii,
                vel_of(V[ia]), vel_of(V[ib]), inv_h)
            IMP[:, cols] = torch.stack(new_imp)
        else:
            dva, dvb = _warm_start_rows(ps, dep[:, cols], imp, ia_im, ia_ii, ib_im, ib_ii)
        d = torch.cat([torch.stack([*dva[0], *dva[1]], -1),
                       torch.stack([*dvb[0], *dvb[1]], -1)]) / sc[sl][:, None]
        V.index_add_(0, idx[sl], d)

    for s in range(n_substeps):
        if s > 0:  # phase 0 reads velocities only: every slice at once
            dep = _inc_depth_rows(ps_t, dep, vel_of(V[ia_all]), vel_of(V[ib_all]), h)
        pos, orn = _pose_vel_inertia_block(
            V, W, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask, h,
            lin_scale, ang_scale, gravity, angular_mode, s)
        for sl in live_slices:
            slice_pass(sl, False)
        for _ in range(n_iters):
            for sl in live_slices:
                slice_pass(sl, True)
    return V, pos, orn, IMP


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch_kernel(v6, pos, orn, inv_mass, lii, grav_mask, integ_mask, ps_t, imp_t, idx2,
                   scale, h, inv_h, lin_scale, ang_scale, sb, n_substeps, n_iters,
                   angular_mode, gravity):
    from . import build

    lib, _ = build.load("substeps_contacts")
    fn = lib.substeps_contacts_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] * 7 + [
        ctypes.c_void_p]

    nb = v6.shape[0]
    B = ps_t.shape[1]
    n_slices = B // sb
    dev = v6.device
    f32 = torch.float32
    bg = torch.zeros((nb, 16), dtype=f32, device=dev)
    bg[:, :6] = v6
    pose = torch.stack([*pos, *orn, torch.zeros_like(pos.x)], -1).contiguous()
    mcode = grav_mask.float() + 2.0 * integ_mask.float()
    aux = torch.stack([inv_mass, *lii, mcode], -1).contiguous()
    imp = imp_t.clone()
    dep = torch.empty((4, B), dtype=f32, device=dev)
    idx = idx2.to(torch.int32).contiguous()
    sc = scale.to(f32).contiguous()
    order = torch.sort(idx.view(n_slices, 2 * sb), dim=1, stable=True).indices
    order = order.to(torch.int32).contiguous()
    slive = (ps_t[PS_VALID].view(n_slices, sb) > 0.5).any(dim=1).to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(bg.data_ptr(), pose.data_ptr(), aux.data_ptr(), ps_t.data_ptr(), imp.data_ptr(),
             dep.data_ptr(), idx.data_ptr(), sc.data_ptr(), order.data_ptr(), slive.data_ptr(),
             nb, B, sb, n_substeps, n_iters, angular_mode,
             float(gravity[0]), float(gravity[1]), float(gravity[2]),
             float(h), float(inv_h), float(lin_scale), float(ang_scale), stream)
    if err != 0:
        raise RuntimeError(f"substeps_contacts kernel launch failed: CUDA error {err}")
    solve_substeps_contacts.launches += 1
    col = lambda t, c: t[:, c].contiguous()
    pos_n = Vec3(col(pose, 0), col(pose, 1), col(pose, 2))
    orn_n = Quat(col(pose, 3), col(pose, 4), col(pose, 5), col(pose, 6))
    return bg[:, :6].contiguous(), pos_n, orn_n, imp


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
):
    """Run the ENTIRE substepped contact solve. Returns (v6', pos', orn', imp_t').

    CUDA tensors go through the CUDA kernel (one launch, counted in
    ``solve_substeps_contacts.launches``); CPU tensors through the plain version."""
    dev = v6.device
    B = ps_t.shape[1]
    nb = v6.shape[0]
    if sb <= 0 or B % sb:
        raise ValueError(f"bank of {B} rows does not split into slices of {sb}")
    f32 = torch.float32
    _check("v6", v6, (nb, 6), f32, dev)
    for name, t in [("pos", pos), ("orn", orn), ("local_inv_inertia", local_inv_inertia)]:
        for c in t:
            _check(name, c, (nb,), f32, dev)
    _check("inv_mass", inv_mass, (nb,), f32, dev)
    _check("grav_mask", grav_mask, (nb,), torch.bool, dev)
    _check("integ_mask", integ_mask, (nb,), torch.bool, dev)
    _check("ps_t", ps_t, (PS_ROWS, B), f32, dev)
    _check("imp_t", imp_t, (IMP_ROWS, B), f32, dev)
    _check("idx2", idx2, (2 * B,), torch.int32, dev)
    _check("scale", scale, (2 * B,), f32, dev)
    args = (v6, pos, orn, inv_mass, local_inv_inertia, grav_mask, integ_mask, ps_t, imp_t,
            idx2, scale, h, inv_h, lin_scale, ang_scale)
    if dev.type == "cuda":
        return _launch_kernel(*args, sb, n_substeps, n_iters, angular_mode, gravity)
    if dev.type != "cpu":
        raise ValueError(f"solve_substeps_contacts runs on cuda or cpu, not {dev.type}")
    return _solve_substeps_contacts_plain(
        *args, sb=sb, n_substeps=n_substeps, n_iters=n_iters, angular_mode=angular_mode,
        gravity=gravity)


solve_substeps_contacts.launches = 0


def synthetic_bank(nb: int, sb: int, n_colored: int, n_jacobi: int, seed: int,
                   dt: float = 1.0 / 60.0, substeps: int = 4):
    """A seeded K1 input with the structure the solver hands it, as numpy arrays: body 0
    is a static ground, colored slices touch each dynamic body at most once (statics may
    repeat), the trailing Jacobi slices share bodies and carry each side's mass-split
    valence as its scale, and partly filled slices end in padding rows (valid 0, scale
    1). Used to hold the kernel against its plain version and the JAX kernel."""
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
    for s in range(n_colored):
        perm = rng.permutation(dyn)
        n_pair = min(sb // 2, len(perm) // 4)
        n_ground = min(sb - n_pair, len(perm) - 2 * n_pair)
        a[s, :n_pair], b[s, :n_pair] = perm[:n_pair], perm[n_pair:2 * n_pair]
        a[s, n_pair:n_pair + n_ground] = perm[2 * n_pair:2 * n_pair + n_ground]
        valid[s, :n_pair + n_ground] = True
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
    return dict(
        v6=v6, pos=pos, orn=orn, inv_mass=inv_mass, local_inv_inertia=lii,
        grav_mask=grav, integ_mask=integ, ps_t=ps, imp_t=imp,
        idx2=slice_major(a, b).astype(np.int32), scale=slice_major(sa, sbs),
        h=float(h), inv_h=float(f32(substeps) / f32(dt)), sb=sb, n_substeps=substeps,
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
