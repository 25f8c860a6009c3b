// K1: the whole substepped contact solve in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_substeps_kernel (solve_substeps_contacts):
// per substep, the incremental depth update (substeps after the first), the pose /
// velocity / world-inertia block, a warm start of every slice, then the velocity
// iterations over every slice, in the same phase order, slice order and per-row math.
//
// What bounds it: latency and L2 traffic, not flops. Each slice is a gather of two body
// rows per constraint row, ~400 flops of per-row algebra, and a scatter of velocity
// deltas; slices must run one after another (Gauss-Seidel over color pages), so the
// critical path is the chain of ~(2 + iterations) x slices x substeps dependent steps.
//
// Design: ONE thread block of 512 threads walks the grid's (substep, phase, slice) order
// itself; __syncthreads() separates slices. Body state lives in device memory (about
// 0.5 MB at 4k bodies, L2-resident). Each slice first computes every row's deltas into
// shared memory, then sums them per body in a fixed order (the wrapper's stable sort of
// the slice's body list), so the result is deterministic by construction: no float
// atomics, and rows of a Jacobi page all read the state from before the slice. This
// uses one SM of 132; spreading the solve over the card is later work. One launch per
// step.
//
// Layouts (row-major, f32 unless noted):
//   bg    (nb, 16)  [vx vy vz wx wy wz 0 0 | im, world inverse inertia xx yx yy zx zy zz, 0]
//   pose  (nb, 8)   [px py pz qx qy qz qw 0]
//   aux   (nb, 8)   [im, local inverse inertia xx yx yy zx zy zz, mask code]
//                   mask code = gravity-mask + 2 * integrate-mask
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract)
//   imp   (8, B)    accumulated impulses, updated in place
//   dep   (4, B)    depth scratch
//   idx2, scale, order  (n_slices * 2 * sb,)  per slice: sb A sides then sb B sides;
//                   order (int32) is the slice's stable sort of its body list
//   slive (n_slices,) int32: slice holds at least one valid row

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512;

// Packed prestep row offsets (ops/sweep.py).
constexpr int PS_N = 0, PS_AX = 3, PS_AY = 7, PS_AZ = 11, PS_B = 15, PS_DEPTH = 18,
              PS_MASK = 22, PS_FRICTION = 26, PS_ERRVEL = 27, PS_CFM = 28, PS_SOFT = 29,
              PS_MAXREC = 30, PS_VALID = 31, PS_ROWS = 32;
constexpr int IMP_ROWS = 8;
constexpr int ANGULAR_CONSERVE_MOMENTUM = 1, ANGULAR_CONSERVE_WITH_GYROSCOPIC = 2;

struct F3 { float x, y, z; };
struct S3 { float xx, yx, yy, zx, zy, zz; };
struct M3 { F3 rx, ry, rz; };
struct Q4 { float x, y, z, w; };

__device__ __forceinline__ F3 f3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(F3 a, F3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float len(F3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ F3 transform(const S3& s, F3 v) {
  return {v.x * s.xx + v.y * s.yx + v.z * s.zx,
          v.x * s.yx + v.y * s.yy + v.z * s.zy,
          v.x * s.zx + v.y * s.zy + v.z * s.zz};
}

__device__ __forceinline__ F3 transform(const M3& m, F3 v) {
  return {v.x * m.rx.x + v.y * m.ry.x + v.z * m.rz.x,
          v.x * m.rx.y + v.y * m.ry.y + v.z * m.rz.y,
          v.x * m.rx.z + v.y * m.ry.z + v.z * m.rz.z};
}
__device__ __forceinline__ F3 transform_transpose(const M3& m, F3 v) {
  return {dot(m.rx, v), dot(m.ry, v), dot(m.rz, v)};
}

__device__ M3 to_matrix(Q4 q) {
  float x2 = q.x + q.x, y2 = q.y + q.y, z2 = q.z + q.z;
  float xx2 = q.x * x2, yy2 = q.y * y2, zz2 = q.z * z2;
  float xy2 = q.x * y2, xz2 = q.x * z2, yz2 = q.y * z2;
  float wx2 = q.w * x2, wy2 = q.w * y2, wz2 = q.w * z2;
  return {f3(1.0f - yy2 - zz2, xy2 + wz2, xz2 - wy2),
          f3(xy2 - wz2, 1.0f - xx2 - zz2, yz2 + wx2),
          f3(xz2 + wy2, yz2 - wx2, 1.0f - xx2 - yy2)};
}

// R^T S R in the reference row convention (utils/vec.py Sym3.rotation_sandwich).
__device__ S3 rotation_sandwich(const S3& s, const M3& r) {
  float ixx = r.rx.x * s.xx + r.ry.x * s.yx + r.rz.x * s.zx;
  float ixy = r.rx.x * s.yx + r.ry.x * s.yy + r.rz.x * s.zy;
  float ixz = r.rx.x * s.zx + r.ry.x * s.zy + r.rz.x * s.zz;
  float iyx = r.rx.y * s.xx + r.ry.y * s.yx + r.rz.y * s.zx;
  float iyy = r.rx.y * s.yx + r.ry.y * s.yy + r.rz.y * s.zy;
  float iyz = r.rx.y * s.zx + r.ry.y * s.zy + r.rz.y * s.zz;
  float izx = r.rx.z * s.xx + r.ry.z * s.yx + r.rz.z * s.zx;
  float izy = r.rx.z * s.yx + r.ry.z * s.yy + r.rz.z * s.zy;
  float izz = r.rx.z * s.zx + r.ry.z * s.zy + r.rz.z * s.zz;
  return {ixx * r.rx.x + ixy * r.ry.x + ixz * r.rz.x,
          iyx * r.rx.x + iyy * r.ry.x + iyz * r.rz.x,
          iyx * r.rx.y + iyy * r.ry.y + iyz * r.rz.y,
          izx * r.rx.x + izy * r.ry.x + izz * r.rz.x,
          izx * r.rx.y + izy * r.ry.y + izz * r.rz.y,
          izx * r.rx.z + izy * r.ry.z + izz * r.rz.z};
}

__device__ S3 sym_inverse(const S3& s) {
  float m11 = s.yy * s.zz - s.zy * s.zy;
  float m21 = s.zy * s.zx - s.zz * s.yx;
  float m31 = s.yx * s.zy - s.zx * s.yy;
  float det = m11 * s.xx + m21 * s.yx + m31 * s.zx;
  float inv = fabsf(det) > 0.0f ? 1.0f / det : 0.0f;
  float m22 = s.zz * s.xx - s.zx * s.zx;
  float m32 = s.zx * s.yx - s.xx * s.zy;
  float m33 = s.xx * s.yy - s.yx * s.yx;
  return {m11 * inv, m21 * inv, m22 * inv, m31 * inv, m32 * inv, m33 * inv};
}

__device__ M3 mat_inverse(const M3& m) {
  F3 c0 = cross(m.ry, m.rz), c1 = cross(m.rz, m.rx), c2 = cross(m.rx, m.ry);
  float det = dot(m.rx, c0);
  float inv_det = fabsf(det) > 0.0f ? 1.0f / det : 0.0f;
  return {f3(c0.x, c1.x, c2.x) * inv_det, f3(c0.y, c1.y, c2.y) * inv_det,
          f3(c0.z, c1.z, c2.z) * inv_det};
}

__device__ M3 cross_matrix(F3 v) {
  return {f3(0.0f, v.z, -v.y), f3(-v.z, 0.0f, v.x), f3(v.y, -v.x, 0.0f)};
}

__device__ M3 matmul(const M3& a, const M3& b) {
  return {transform(b, a.rx), transform(b, a.ry), transform(b, a.rz)};
}

__device__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}

// utils/vec.py integrate_orientation.
__device__ Q4 integrate_orientation(Q4 orn, F3 omega, float dt) {
  float speed = len(omega);
  if (!(speed > 1e-15f)) return orn;
  float half_angle = speed * dt * 0.5f;
  float scale = sinf(half_angle) / fmaxf(speed, 1e-15f);
  Q4 dq = {omega.x * scale, omega.y * scale, omega.z * scale, cosf(half_angle)};
  Q4 q = qmul(dq, orn);
  float inv = 1.0f / sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w);
  return {q.x * inv, q.y * inv, q.z * inv, q.w * inv};
}

__device__ F3 fallback_if_incompatible(F3 prev, F3 nw) {
  bool ok = fabsf(nw.x) < INFINITY && fabsf(nw.y) < INFINITY && fabsf(nw.z) < INFINITY;
  return ok ? nw : prev;
}

// integrator.py integrate_angular_conserve_momentum.
__device__ F3 conserve_momentum(Q4 prev_orn, const S3& loc, const S3& world, F3 omega) {
  M3 r_prev = to_matrix(prev_orn);
  F3 local_omega = transform_transpose(r_prev, omega);
  S3 local_inertia = sym_inverse(loc);
  F3 momentum = transform(r_prev, transform(local_inertia, local_omega));
  return fallback_if_incompatible(omega, transform(world, momentum));
}

// integrator.py integrate_angular_gyroscopic.
__device__ F3 gyroscopic(Q4 orn, const S3& loc, F3 omega, float dt) {
  M3 r = to_matrix(orn);
  F3 local_omega = transform_transpose(r, omega);
  S3 li = sym_inverse(loc);
  F3 local_momentum = transform(li, local_omega);
  F3 residual = cross(local_momentum, local_omega) * dt;
  M3 skew_momentum = cross_matrix(local_momentum);
  M3 skew_velocity = cross_matrix(local_omega);
  M3 inertia_m = {f3(li.xx, li.yx, li.zx), f3(li.yx, li.yy, li.zy), f3(li.zx, li.zy, li.zz)};
  M3 sv = matmul(skew_velocity, inertia_m);
  M3 change = {(sv.rx - skew_momentum.rx) * dt, (sv.ry - skew_momentum.ry) * dt,
               (sv.rz - skew_momentum.rz) * dt};
  M3 jac = {inertia_m.rx + change.rx, inertia_m.ry + change.ry, inertia_m.rz + change.rz};
  F3 newton_step = transform(mat_inverse(jac), residual);
  local_omega = local_omega - newton_step;
  return fallback_if_incompatible(omega, transform(r, local_omega));
}

struct Params {
  float* bg; float* pose; const float* aux; const float* ps; float* imp; float* dep;
  const int* idx2; const float* scale; const int* order; const int* slive;
  int nb, B, sb, n_slices, n_substeps, n_iters, angular_mode;
  float gx, gy, gz, h, inv_h, lin_scale, ang_scale;
};

// ---- per-row contact math (ops/sweep.py _friction_center_rows, _warm_start_rows,
// _solve_contact_rows, _inc_depth_rows). Shared with the general-path sweep (K3) later.

struct Row {
  float ps[PS_ROWS];
};

__device__ __forceinline__ F3 row_off(const Row& r, int k) {
  return f3(r.ps[PS_AX + k], r.ps[PS_AY + k], r.ps[PS_AZ + k]);
}

__device__ F3 friction_center_rows(const Row& r, const float dep[4], float live_f[4]) {
  float w_raw[4];
  for (int k = 0; k < 4; ++k) {
    live_f[k] = r.ps[PS_MASK + k];
    w_raw[k] = (dep[k] < 0.0f ? 0.0f : 1.0f) * live_f[k];
  }
  float wsum = w_raw[0] + w_raw[1] + w_raw[2] + w_raw[3];
  float live_count = fmaxf(live_f[0] + live_f[1] + live_f[2] + live_f[3], 1.0f);
  bool fallback = wsum == 0.0f;
  F3 center = f3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 4; ++k) {
    float w = fallback ? live_f[k] / live_count : w_raw[k] / fmaxf(wsum, 1.0f);
    center = center + row_off(r, k) * w;
  }
  return center;
}

__device__ void build_orthonormal_basis(F3 n, F3& t1, F3& t2) {
  float sign = n.z < 0.0f ? -1.0f : 1.0f;
  float scale = -1.0f / (sign + n.z);
  t1 = f3(n.x * n.y * scale, sign + n.y * n.y * scale, -n.y);
  t2 = f3(1.0f + sign * n.x * n.x * scale, sign * t1.x, -sign * n.x);
}

__device__ void warm_start_rows(const Row& r, const float dep[4], const float imp[8],
                                float ia_im, const S3& ia_ii, float ib_im, const S3& ib_ii,
                                F3& dva_l, F3& dva_a, F3& dvb_l, F3& dvb_a) {
  F3 n = f3(r.ps[PS_N], r.ps[PS_N + 1], r.ps[PS_N + 2]);
  F3 off_b = f3(r.ps[PS_B], r.ps[PS_B + 1], r.ps[PS_B + 2]);
  bool valid = r.ps[PS_VALID] > 0.5f;
  float live_f[4];
  F3 center_a = friction_center_rows(r, dep, live_f);
  F3 center_b = center_a - off_b;
  F3 t1, t2;
  build_orthonormal_basis(n, t1, t2);
  float tx = valid ? imp[4] : 0.0f;
  float ty = valid ? imp[5] : 0.0f;
  float tw = valid ? imp[6] : 0.0f;
  F3 tangent_w = t1 * tx + t2 * ty;
  F3 lin = tangent_w;
  F3 ang_a = cross(center_a, tangent_w);
  F3 ang_b = cross(tangent_w, center_b);
  for (int k = 0; k < 4; ++k) {
    float pen_k = imp[k] * live_f[k] * (valid ? 1.0f : 0.0f);
    F3 off_k = row_off(r, k);
    F3 off_bk = off_k - off_b;
    lin = lin + n * pen_k;
    ang_a = ang_a + cross(off_k, n) * pen_k;
    ang_b = ang_b + cross(n, off_bk) * pen_k;
  }
  ang_a = ang_a + n * tw;
  ang_b = ang_b - n * tw;
  dva_l = lin * ia_im;
  dva_a = transform(ia_ii, ang_a);
  dvb_l = lin * -1.0f * ib_im;
  dvb_a = transform(ib_ii, ang_b);
}

__device__ void solve_contact_rows(const Row& r, const float dep[4], float imp[8],
                                   float im_a, const S3& ia_ii, float im_b, const S3& ib_ii,
                                   F3 va_l0, F3 va_a0, F3 vb_l0, F3 vb_a0, float inv_h,
                                   F3& dva_l, F3& dva_a, F3& dvb_l, F3& dvb_a) {
  F3 n = f3(r.ps[PS_N], r.ps[PS_N + 1], r.ps[PS_N + 2]);
  float err_vel = r.ps[PS_ERRVEL], cfm = r.ps[PS_CFM], softness = r.ps[PS_SOFT];
  bool valid = r.ps[PS_VALID] > 0.5f;
  F3 off_b = f3(r.ps[PS_B], r.ps[PS_B + 1], r.ps[PS_B + 2]);
  dva_l = dva_a = dvb_l = dvb_a = f3(0.0f, 0.0f, 0.0f);

  float live_f[4];
  F3 center_a = friction_center_rows(r, dep, live_f);
  F3 center_b = center_a - off_b;
  float pen_new[4];
  float pen_masked_sum = 0.0f, pen_lever_sum = 0.0f;
  for (int k = 0; k < 4; ++k) {
    F3 off_k = row_off(r, k);
    F3 off_bk = off_k - off_b;
    F3 ang_a = cross(off_k, n);
    F3 ang_b = cross(n, off_bk);
    F3 ang_a_im = transform(ia_ii, ang_a);
    F3 ang_b_im = transform(ib_ii, ang_b);
    float inv_eff = im_a + im_b + dot(ang_a, ang_a_im) + dot(ang_b, ang_b_im);
    float eff = inv_eff > 0.0f ? cfm / fmaxf(inv_eff, 1e-30f) : 0.0f;
    float depth_k = dep[k];
    float bias = fminf(depth_k * inv_h, fminf(depth_k * err_vel, r.ps[PS_MAXREC]));
    float csv = dot(va_l0 + dva_l, n) - dot(vb_l0 + dvb_l, n) + dot(va_a0 + dva_a, ang_a)
                + dot(vb_a0 + dvb_a, ang_b);
    float acc_k = imp[k];
    float negated_csi = acc_k * softness + (csv - bias) * eff;
    float new_acc = fmaxf(0.0f, acc_k - negated_csi);
    bool live = live_f[k] > 0.5f && valid;
    new_acc = live ? new_acc : acc_k;
    float corrective = live ? new_acc - acc_k : 0.0f;
    pen_new[k] = new_acc;
    F3 lin = n * corrective;
    dva_l = dva_l + lin * im_a;
    dva_a = dva_a + ang_a_im * corrective;
    dvb_l = dvb_l - lin * im_b;
    dvb_a = dvb_a + ang_b_im * corrective;
    float pm = new_acc * live_f[k];
    pen_masked_sum = k == 0 ? pm : pen_masked_sum + pm;
    float pl = pm * len(off_k - center_a);
    pen_lever_sum = k == 0 ? pl : pen_lever_sum + pl;
  }

  // Tangent friction (2-DOF block at the manifold center).
  F3 t1, t2;
  build_orthonormal_basis(n, t1, t2);
  F3 ang_a1 = cross(center_a, t1), ang_a2 = cross(center_a, t2);
  F3 ang_b1 = cross(t1, center_b), ang_b2 = cross(t2, center_b);
  F3 ang_a1_im = transform(ia_ii, ang_a1), ang_a2_im = transform(ia_ii, ang_a2);
  F3 ang_b1_im = transform(ib_ii, ang_b1), ang_b2_im = transform(ib_ii, ang_b2);
  float imass = im_a + im_b;
  float m11 = imass + dot(ang_a1, ang_a1_im) + dot(ang_b1, ang_b1_im);
  float m22 = imass + dot(ang_a2, ang_a2_im) + dot(ang_b2, ang_b2_im);
  float m12 = dot(ang_a1_im, ang_a2) + dot(ang_b1_im, ang_b2);
  float det = m11 * m22 - m12 * m12;
  float dinv = fabsf(det) > 0.0f ? 1.0f / det : 0.0f;
  float e_xx = m22 * dinv, e_yx = -m12 * dinv, e_yy = m11 * dinv;

  F3 va_l = va_l0 + dva_l, va_a = va_a0 + dva_a, vb_l = vb_l0 + dvb_l, vb_a = vb_a0 + dvb_a;
  float csv1 = dot(vb_l, t1) - dot(va_l, t1) - dot(va_a, ang_a1) - dot(vb_a, ang_b1);
  float csv2 = dot(vb_l, t2) - dot(va_l, t2) - dot(va_a, ang_a2) - dot(vb_a, ang_b2);
  float csi_x = csv1 * e_xx + csv2 * e_yx;
  float csi_y = csv1 * e_yx + csv2 * e_yy;

  float contact_count = fmaxf(live_f[0] + live_f[1] + live_f[2] + live_f[3], 1.0f);
  float premul_friction = r.ps[PS_FRICTION] / contact_count;
  float max_tangent = premul_friction * pen_masked_sum;
  float prev_tx = imp[4], prev_ty = imp[5];
  float new_tx = prev_tx + csi_x, new_ty = prev_ty + csi_y;
  float mag = sqrtf(new_tx * new_tx + new_ty * new_ty);
  float sc = fminf(1.0f, max_tangent / fmaxf(1e-16f, mag));
  new_tx = new_tx * sc;
  new_ty = new_ty * sc;
  new_tx = valid ? new_tx : prev_tx;
  new_ty = valid ? new_ty : prev_ty;
  float cx = new_tx - prev_tx, cy = new_ty - prev_ty;
  F3 lin_t = t1 * cx + t2 * cy;
  dva_l = dva_l + lin_t * im_a;
  dva_a = dva_a + ang_a1_im * cx + ang_a2_im * cy;
  dvb_l = dvb_l - lin_t * im_b;
  dvb_a = dvb_a + ang_b1_im * cx + ang_b2_im * cy;

  // Twist friction.
  bool single = contact_count <= 1.0f;
  float lever0 = fmaxf(0.0f, dep[0]);
  float twist_cap = single ? premul_friction * pen_new[0] * live_f[0] * lever0
                           : premul_friction * pen_lever_sum;
  F3 n_im_a = transform(ia_ii, n), n_im_b = transform(ib_ii, n);
  float inv_eff_tw = dot(n, n_im_a) + dot(n, n_im_b);
  float eff_tw = inv_eff_tw == 0.0f ? 0.0f : 1.0f / fmaxf(inv_eff_tw, 1e-30f);
  float csv_tw = dot(va_a0 + dva_a, n) - dot(vb_a0 + dvb_a, n);
  float csi_tw = -csv_tw * eff_tw;
  float prev_tw = imp[6];
  float new_tw = fminf(fmaxf(prev_tw + csi_tw, -twist_cap), twist_cap);
  new_tw = valid ? new_tw : prev_tw;
  float corr_tw = new_tw - prev_tw;
  dva_a = dva_a + n_im_a * corr_tw;
  dvb_a = dvb_a - n_im_b * corr_tw;

  for (int k = 0; k < 4; ++k) imp[k] = pen_new[k];
  imp[4] = new_tx;
  imp[5] = new_ty;
  imp[6] = new_tw;
  imp[7] = 0.0f;
}

__device__ void inc_depth_rows(const Row& r, float dep[4], F3 va_l, F3 va_a, F3 vb_l,
                               F3 vb_a, float h) {
  F3 n = f3(r.ps[PS_N], r.ps[PS_N + 1], r.ps[PS_N + 2]);
  F3 off_b = f3(r.ps[PS_B], r.ps[PS_B + 1], r.ps[PS_B + 2]);
  for (int k = 0; k < 4; ++k) {
    F3 off_k = row_off(r, k);
    F3 cv_a = cross(va_a, off_k) + va_l;
    F3 cv_b = cross(vb_a, off_k - off_b) + vb_l;
    dep[k] = dep[k] - dot(n, cv_a - cv_b) * h;
  }
}

// ---- block-wide pieces ------------------------------------------------------------

__device__ __forceinline__ void load_row(const Params& p, int col, Row& r) {
#pragma unroll
  for (int c = 0; c < PS_ROWS; ++c) r.ps[c] = p.ps[(size_t)c * p.B + col];
}

__device__ __forceinline__ void load_vel(const Params& p, int b, F3& l, F3& a) {
  const float* g = p.bg + (size_t)b * 16;
  l = f3(g[0], g[1], g[2]);
  a = f3(g[3], g[4], g[5]);
}

__device__ __forceinline__ void load_inertia(const Params& p, int b, float s, float& im, S3& ii) {
  const float* g = p.bg + (size_t)b * 16;
  im = g[8] * s;
  ii = {g[9] * s, g[10] * s, g[11] * s, g[12] * s, g[13] * s, g[14] * s};
}

// Substep boundary on every body: pose integration (s > 0), gravity and damping, and
// the world inverse inertia refresh (ops/sweep.py _pose_vel_inertia_block).
__device__ void pose_vel_inertia_block(const Params& p, int s) {
  for (int b = threadIdx.x; b < p.nb; b += blockDim.x) {
    float* g = p.bg + (size_t)b * 16;
    float* ps = p.pose + (size_t)b * 8;
    const float* ax = p.aux + (size_t)b * 8;
    S3 loc = {ax[1], ax[2], ax[3], ax[4], ax[5], ax[6]};
    float mcode = ax[7];
    bool gmask = fmodf(mcode, 2.0f) > 0.5f;
    bool imask = mcode >= 2.0f;
    F3 vel = f3(g[0], g[1], g[2]);
    F3 omg = f3(g[3], g[4], g[5]);
    Q4 orn = {ps[3], ps[4], ps[5], ps[6]};
    if (s > 0 && imask) {
      F3 pos = f3(ps[0], ps[1], ps[2]);
      pos = pos + vel * p.h;
      Q4 new_orn = integrate_orientation(orn, omg, p.h);
      ps[0] = pos.x; ps[1] = pos.y; ps[2] = pos.z;
      ps[3] = new_orn.x; ps[4] = new_orn.y; ps[5] = new_orn.z; ps[6] = new_orn.w;
      if (gmask) {
        if (p.angular_mode == ANGULAR_CONSERVE_MOMENTUM) {
          S3 world_new = rotation_sandwich(loc, to_matrix(new_orn));
          omg = conserve_momentum(orn, loc, world_new, omg);
        } else if (p.angular_mode == ANGULAR_CONSERVE_WITH_GYROSCOPIC) {
          omg = gyroscopic(new_orn, loc, omg, p.h);
        }
      }
      orn = new_orn;
    }
    if (gmask) {
      vel = f3((vel.x + p.gx * p.h) * p.lin_scale, (vel.y + p.gy * p.h) * p.lin_scale,
               (vel.z + p.gz * p.h) * p.lin_scale);
      omg = omg * p.ang_scale;
    }
    g[0] = vel.x; g[1] = vel.y; g[2] = vel.z;
    g[3] = omg.x; g[4] = omg.y; g[5] = omg.z;
    S3 w = rotation_sandwich(loc, to_matrix(orn));
    g[8] = ax[0];
    g[9] = w.xx; g[10] = w.yx; g[11] = w.yy; g[12] = w.zx; g[13] = w.zy; g[14] = w.zz;
  }
}

// One slice of warm start (solve = false) or of one velocity iteration (solve = true):
// every row's deltas go to shared memory (divided by the side's mass-split scale), then
// each body's deltas are summed onto its velocity in the slice's sorted order.
__device__ void run_slice(const Params& p, int sl, bool solve, float* D) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  for (int r = threadIdx.x; r < sb; r += blockDim.x) {
    const int col = sl * sb + r;
    Row row;
    load_row(p, col, row);
    float dep[4], imp[IMP_ROWS];
    for (int k = 0; k < 4; ++k) dep[k] = p.dep[(size_t)k * p.B + col];
    for (int k = 0; k < IMP_ROWS; ++k) imp[k] = p.imp[(size_t)k * p.B + col];
    const int ba = p.idx2[e0 + r], bb = p.idx2[e0 + sb + r];
    const float sa = p.scale[e0 + r], sbs = p.scale[e0 + sb + r];
    float ia_im, ib_im;
    S3 ia_ii, ib_ii;
    load_inertia(p, ba, sa, ia_im, ia_ii);
    load_inertia(p, bb, sbs, ib_im, ib_ii);
    F3 dva_l, dva_a, dvb_l, dvb_a;
    if (solve) {
      F3 va_l, va_a, vb_l, vb_a;
      load_vel(p, ba, va_l, va_a);
      load_vel(p, bb, vb_l, vb_a);
      solve_contact_rows(row, dep, imp, ia_im, ia_ii, ib_im, ib_ii, va_l, va_a, vb_l, vb_a,
                         p.inv_h, dva_l, dva_a, dvb_l, dvb_a);
      for (int k = 0; k < IMP_ROWS; ++k) p.imp[(size_t)k * p.B + col] = imp[k];
    } else {
      warm_start_rows(row, dep, imp, ia_im, ia_ii, ib_im, ib_ii, dva_l, dva_a, dvb_l, dvb_a);
    }
    float* da = D + (size_t)r * 6;
    float* db = D + (size_t)(sb + r) * 6;
    da[0] = dva_l.x / sa; da[1] = dva_l.y / sa; da[2] = dva_l.z / sa;
    da[3] = dva_a.x / sa; da[4] = dva_a.y / sa; da[5] = dva_a.z / sa;
    db[0] = dvb_l.x / sbs; db[1] = dvb_l.y / sbs; db[2] = dvb_l.z / sbs;
    db[3] = dvb_a.x / sbs; db[4] = dvb_a.y / sbs; db[5] = dvb_a.z / sbs;
  }
  __syncthreads();
  // Fixed-order per-body sums: the first entry of each body's run in the sorted list
  // adds the whole run. Bodies with zero inverse mass and inertia take no delta.
  const int* ord = p.order + e0;
  const int* idx = p.idx2 + e0;
  for (int q = threadIdx.x; q < 2 * sb; q += blockDim.x) {
    const int b = idx[ord[q]];
    if (q > 0 && idx[ord[q - 1]] == b) continue;
    float* g = p.bg + (size_t)b * 16;
    if (g[8] == 0.0f && g[9] == 0.0f && g[10] == 0.0f && g[11] == 0.0f && g[12] == 0.0f &&
        g[13] == 0.0f && g[14] == 0.0f)
      continue;
    float acc[6];
    for (int c = 0; c < 6; ++c) acc[c] = g[c];
    for (int q2 = q; q2 < 2 * sb && idx[ord[q2]] == b; ++q2) {
      const float* d = D + (size_t)ord[q2] * 6;
      for (int c = 0; c < 6; ++c) acc[c] += d[c];
    }
    for (int c = 0; c < 6; ++c) g[c] = acc[c];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS) substeps_contacts_kernel(Params p) {
  extern __shared__ float D[];
  const int sb = p.sb;
  for (int s = 0; s < p.n_substeps; ++s) {
    // Phase 0: incremental depth update for substeps after the first. It reads the
    // velocities only, so every slice's rows run at once.
    if (s > 0) {
      for (int col = threadIdx.x; col < p.B; col += blockDim.x) {
        const int sl = col / sb, r = col - sl * sb;
        if (!p.slive[sl]) continue;
        const size_t e0 = (size_t)sl * 2 * sb;
        Row row;
        load_row(p, col, row);
        float dep[4];
        for (int k = 0; k < 4; ++k) dep[k] = p.dep[(size_t)k * p.B + col];
        F3 va_l, va_a, vb_l, vb_a;
        load_vel(p, p.idx2[e0 + r], va_l, va_a);
        load_vel(p, p.idx2[e0 + sb + r], vb_l, vb_a);
        inc_depth_rows(row, dep, va_l, va_a, vb_l, vb_a, p.h);
        for (int k = 0; k < 4; ++k) p.dep[(size_t)k * p.B + col] = dep[k];
      }
      __syncthreads();
    }
    // Phase 1: the body block, then (first substep) the depth scratch from the prestep,
    // then the warm start of every slice.
    pose_vel_inertia_block(p, s);
    if (s == 0) {
      for (int col = threadIdx.x; col < p.B; col += blockDim.x)
        for (int k = 0; k < 4; ++k)
          p.dep[(size_t)k * p.B + col] = p.ps[(size_t)(PS_DEPTH + k) * p.B + col];
    }
    __syncthreads();
    for (int sl = 0; sl < p.n_slices; ++sl)
      if (p.slive[sl]) run_slice(p, sl, false, D);
    // Phases 2+: velocity iterations.
    for (int it = 0; it < p.n_iters; ++it)
      for (int sl = 0; sl < p.n_slices; ++sl)
        if (p.slive[sl]) run_slice(p, sl, true, D);
  }
}

}  // namespace

extern "C" int substeps_contacts_launch(
    float* bg, float* pose, const float* aux, const float* ps_t, float* imp, float* dep,
    const int* idx2, const float* scale, const int* order, const int* slive,
    int nb, int B, int sb, int n_substeps, int n_iters, int angular_mode,
    float gx, float gy, float gz, float h, float inv_h, float lin_scale, float ang_scale,
    void* stream) {
  Params p{bg, pose, aux, ps_t, imp, dep, idx2, scale, order, slive,
           nb, B, sb, B / sb, n_substeps, n_iters, angular_mode,
           gx, gy, gz, h, inv_h, lin_scale, ang_scale};
  const size_t smem = (size_t)2 * sb * 6 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        substeps_contacts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  substeps_contacts_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
