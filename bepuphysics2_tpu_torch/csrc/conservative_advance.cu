// K8: conservative advancement to the time of impact, one thread per record, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes this loop in XLA, which compiles its
// fori_loop of gjk_closest into one device loop (bepuphysics2_tpu/collision/sweeps.py:
// sweep_shape_all's advancement and pair_toi's _advance). The port ran the same loop as
// eager PyTorch ops: every GJK iteration of every advancement iteration is a few hundred
// small masked kernels (~28,600 an advancement iteration), so one 32-iteration sweep
// call launched ~915,000 kernels, and a CCD pass of 12 iterations ~340,000. This kernel
// runs the whole loop of one record in one thread: collision/sweeps.py _advance, with
// collision/convex.py's support mappings and gjk_closest inlined.
//
// What bounds it: operations. Each record reads ~70 words and writes one, but runs up
// to `iters` GJK calls of up to 24 iterations, each a distance subalgorithm over 4
// vertices, 6 edges and 4 faces (~600 flops) and two support mappings; a hull's support
// walks its pool rows. A thread stops at its record's impact or miss, as the masked
// version's result stops changing there, so a record costs what it needs.
//
// Rounding: every operation is written in the plain version's order (utils/vec.py's
// formulas, left to right), and the file is built with -fmad=false (ops/build.py), so
// no multiply-add is contracted: each operation rounds as one PyTorch op does. sinf,
// cosf, sqrtf and division are the IEEE-rounded ones PyTorch's CUDA ops call.
//
// Layouts (row-major, float32 unless said): f (n, 35) per record: the swept body's
// position 0-2, orientation 3-6 (x, y, z, w), velocity 7-9, angular velocity 10-12; the
// target owner's position 13-15, orientation 16-19, velocity 20-22, angular velocity
// 23-25; the target's local position 26-28 and orientation 29-32; the speed bound 33;
// max_t 34. ti (n, 3) int32: A's type, B's type, exists. params_a (n or 1, 12) with row
// stride pa_stride (12, or 0 for one row shared by all), params_b (n, 12); hull_x/y/z
// (P,) the hull pool; hull_a (n or 1, H) int32 pool rows (-1 padded) with row stride
// ha_stride (H or 0), hull_b (n, H). out (n,): the time of impact, or the miss value
// (3e38, or the record's max_t where miss_max_t is 1). work (n, 2) int32, or null: the
// advancement iterations and the GJK iterations the record ran (the work its data needs,
// for the bound a measurement states).

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NF = 35;
constexpr int GJK_ITERS = 24;
// shapes/registry.py's type ids.
constexpr int SPHERE = 0, CAPSULE = 1, TRIANGLE = 3, CYLINDER = 4, CONVEX_HULL = 5;
constexpr float INF_T = 3.0e38f;

struct V3 {
  float x, y, z;
};
struct Q {
  float x, y, z, w;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ Q qmul(Q a, Q b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}
__device__ __forceinline__ Q conj(Q q) { return {-q.x, -q.y, -q.z, q.w}; }

// q v q*: t = 2 (q.xyz x v); v' = v + w t + q.xyz x t.
__device__ __forceinline__ V3 rotate(Q q, V3 v) {
  const V3 qv = {q.x, q.y, q.z};
  const V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q.w)), cross(qv, t));
}
__device__ __forceinline__ V3 rotate_inverse(Q q, V3 v) { return rotate(conj(q), v); }

// utils/vec.py integrate_orientation.
__device__ __forceinline__ Q integrate_orientation(Q orn, V3 omega, float dt) {
  const float speed = sqrtf(dot(omega, omega));
  const float half = speed * dt * 0.5f;
  const bool spins = speed > 1e-15f;
  const float s = spins ? sinf(half) / fmaxf(speed, 1e-15f) : 0.0f;
  const Q dq = {omega.x * s, omega.y * s, omega.z * s, cosf(half)};
  const Q m = qmul(dq, orn);
  const float inv = 1.0f / sqrtf(m.x * m.x + m.y * m.y + m.z * m.z + m.w * m.w);
  const Q out = {m.x * inv, m.y * inv, m.z * inv, m.w * inv};
  return spins ? out : orn;
}

// One side of a record: its type, packed params and hull pool rows.
struct Side {
  int type;
  const float* p;
  const int* hull;
};

struct Pool {
  const float *x, *y, *z;
  int width;  // H, the hull-row table's width
};

// convex.py support_core: the core's support point in the shape's frame, and its margin.
__device__ __forceinline__ V3 support_core(const Side& s, const Pool& pool, V3 d,
                                           float* margin) {
  const float* p = s.p;
  *margin = (s.type == SPHERE || s.type == CAPSULE) ? p[0] : 0.0f;
  switch (s.type) {
    case SPHERE:
      return {0.0f, 0.0f, 0.0f};
    case CAPSULE:
      return {0.0f, d.y >= 0.0f ? p[1] : -p[1], 0.0f};
    case CYLINDER: {
      const float horiz = sqrtf(d.x * d.x + d.z * d.z);
      const float inv_h = horiz > 1e-12f ? 1.0f / fmaxf(horiz, 1e-12f) : 0.0f;
      return {d.x * inv_h * p[0], d.y >= 0.0f ? p[1] : -p[1], d.z * inv_h * p[0]};
    }
    case TRIANGLE: {
      const V3 va = {p[0], p[1], p[2]}, vb = {p[3], p[4], p[5]}, vc = {p[6], p[7], p[8]};
      const float da = dot(d, va), db = dot(d, vb), dc = dot(d, vc);
      return (da >= db && da >= dc) ? va : (db >= dc ? vb : vc);
    }
    case CONVEX_HULL: {
      // The first maximal vertex of the record's pool rows (-1 rows rank last).
      int best = 0;
      float best_dot = 0.0f;
      for (int j = 0; j < pool.width; ++j) {
        const int r = s.hull[j];
        const float v = r >= 0 ? d.x * pool.x[r] + d.y * pool.y[r] + d.z * pool.z[r]
                               : -3.0e38f;
        if (j == 0 || v > best_dot) {
          best = j;
          best_dot = v;
        }
      }
      const int r = max(s.hull[best], 0);
      return {pool.x[r], pool.y[r], pool.z[r]};
    }
    default:  // the box, and the plain version's fallback for any other type
      return {d.x >= 0.0f ? p[0] : -p[0], d.y >= 0.0f ? p[1] : -p[1],
              d.z >= 0.0f ? p[2] : -p[2]};
  }
}

struct Ctx {
  Side a, b;
  Q orn_ab;  // B-local to A's frame
  V3 pos_ab;  // B's centre in A's frame
};

// convex.py minkowski_support: the support of A - B in direction d; margins summed.
__device__ __forceinline__ V3 minkowski(const Ctx& c, const Pool& pool, V3 d, float* margin) {
  float ma, mb;
  const V3 sa = support_core(c.a, pool, d, &ma);
  const V3 sb_local = support_core(c.b, pool, rotate_inverse(c.orn_ab, neg(d)), &mb);
  const V3 sb = add(rotate(c.orn_ab, sb_local), c.pos_ab);
  *margin = ma + mb;
  return sub(sa, sb);
}

// convex.py _closest_on_simplex: the nearest point to the origin over every live
// vertex, edge and face, in that order, a later candidate replacing the best only when
// strictly nearer. keep: bit k set where the nearest feature keeps point k.
__device__ __forceinline__ V3 closest_on_simplex(const V3 pts[4], int mask, int* keep) {
  float best_d2 = 3.0e38f;
  float bary[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int best_keep = 0;
  for (int i = 0; i < 4; ++i) {
    const float d2 = dot(pts[i], pts[i]);
    if (((mask >> i) & 1) && d2 < best_d2) {
      best_d2 = d2;
      for (int k = 0; k < 4; ++k) bary[k] = k == i ? 1.0f : 0.0f;
      best_keep = 1 << i;
    }
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = i + 1; j < 4; ++j) {
      const V3 a = pts[i], b = pts[j];
      const V3 ab = sub(b, a);
      const float denom = dot(ab, ab);
      const float t = fminf(fmaxf(-dot(a, ab) / fmaxf(denom, 1e-30f), 0.0f), 1.0f);
      const V3 p = add(a, scale(ab, t));
      const bool ok = ((mask >> i) & 1) && ((mask >> j) & 1) && denom > 1e-30f && t > 0.0f &&
                      t < 1.0f;
      const float d2 = dot(p, p);
      if (ok && d2 < best_d2) {
        best_d2 = d2;
        for (int k = 0; k < 4; ++k) bary[k] = k == i ? 1.0f - t : (k == j ? t : 0.0f);
        best_keep = (1 << i) | (1 << j);
      }
    }
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = i + 1; j < 4; ++j) {
      for (int k = j + 1; k < 4; ++k) {
        const V3 a = pts[i], b = pts[j], c = pts[k];
        const V3 ab = sub(b, a), ac = sub(c, a);
        const V3 n = cross(ab, ac);
        const float nn = dot(n, n);
        const V3 p = scale(n, dot(a, n) / fmaxf(nn, 1e-30f));
        const V3 ap = sub(p, a);
        const float d00 = dot(ab, ab), d01 = dot(ab, ac), d11 = dot(ac, ac);
        const float d20 = dot(ap, ab), d21 = dot(ap, ac);
        const float den = d00 * d11 - d01 * d01;
        const float sden = den == 0.0f ? 1.0f : (den > 0.0f ? 1.0f : (den < 0.0f ? -1.0f : 0.0f));
        const float aden = fmaxf(fabsf(den), 1e-30f);
        const float v = (d11 * d20 - d01 * d21) / aden * sden;
        const float w = (d00 * d21 - d01 * d20) / aden * sden;
        const float u = 1.0f - v - w;
        const bool ok = ((mask >> i) & 1) && ((mask >> j) & 1) && ((mask >> k) & 1) &&
                        nn > 1e-30f && u > 0.0f && v > 0.0f && w > 0.0f;
        const float d2 = dot(p, p);
        if (ok && d2 < best_d2) {
          best_d2 = d2;
          for (int q = 0; q < 4; ++q)
            bary[q] = q == i ? u : (q == j ? v : (q == k ? w : 0.0f));
          best_keep = (1 << i) | (1 << j) | (1 << k);
        }
      }
    }
  }
  *keep = best_keep;
  V3 out = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 4; ++i) {
    out.x = out.x + bary[i] * pts[i].x;
    out.y = out.y + bary[i] * pts[i].y;
    out.z = out.z + bary[i] * pts[i].z;
  }
  return out;
}

__device__ __forceinline__ bool same_side(V3 a, V3 b, V3 c, V3 d) {
  const V3 n = cross(sub(b, a), sub(c, a));
  return dot(n, neg(a)) * dot(n, sub(d, a)) >= 0.0f;
}

// convex.py gjk_closest, its distance only: the surface distance (the cores' distance
// less the margins).
__device__ float gjk_surface_distance(const Ctx& c, const Pool& pool, int* gjk_iters) {
  const V3 d0 = dot(c.pos_ab, c.pos_ab) > 1e-12f ? neg(c.pos_ab) : V3{0.0f, 1.0f, 0.0f};
  float margin, unused;
  V3 pts[4] = {minkowski(c, pool, d0, &margin), {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
               {0.0f, 0.0f, 0.0f}};
  int mask = 1;
  for (int it = 0; it < GJK_ITERS; ++it) {
    ++*gjk_iters;
    int keep;
    const V3 closest = closest_on_simplex(pts, mask, &keep);
    const float dist2 = dot(closest, closest);
    const V3 w = minkowski(c, pool, neg(closest), &unused);
    const bool progress = (-dot(w, closest) + dist2) > 1e-6f * fmaxf(dist2, 1e-6f);
    // Done is absorbing: the simplex and so the closest point stay as they are.
    if (!progress || dist2 < 1e-12f) break;
    int slot = 0;  // the first slot the nearest feature does not keep
    while (slot < 3 && ((keep >> slot) & 1)) ++slot;
    if ((keep >> slot) & 1) slot = 0;
    pts[slot] = w;
    mask = keep | (1 << slot);
  }
  int keep;
  const V3 closest = closest_on_simplex(pts, mask, &keep);
  float dist = sqrtf(dot(closest, closest));
  // The origin inside a tetrahedron with volume: overlap.
  const V3 e1 = sub(pts[1], pts[0]), e2 = sub(pts[2], pts[0]), e3 = sub(pts[3], pts[0]);
  const float vol = dot(cross(e1, e2), e3);
  const float m2 = fmaxf(dot(e1, e1), fmaxf(dot(e2, e2), dot(e3, e3)));
  const bool nondegenerate = fabsf(vol) > 1e-6f * m2 * sqrtf(fmaxf(m2, 1e-30f));
  const bool contained = mask == 15 && nondegenerate &&
                         same_side(pts[0], pts[1], pts[2], pts[3]) &&
                         same_side(pts[0], pts[1], pts[3], pts[2]) &&
                         same_side(pts[0], pts[2], pts[3], pts[1]) &&
                         same_side(pts[1], pts[2], pts[3], pts[0]);
  if (contained) dist = 0.0f;
  return dist - margin;
}

__device__ __forceinline__ V3 v3_at(const float* f, int i) { return {f[i], f[i + 1], f[i + 2]}; }
__device__ __forceinline__ Q q_at(const float* f, int i) {
  return {f[i], f[i + 1], f[i + 2], f[i + 3]};
}

__global__ void __launch_bounds__(NTHREADS)
    advance_kernel(const float* __restrict__ f, const int* __restrict__ ti,
                   const float* __restrict__ params_a, int pa_stride,
                   const float* __restrict__ params_b, const float* __restrict__ hull_x,
                   const float* __restrict__ hull_y, const float* __restrict__ hull_z,
                   const int* __restrict__ hull_a, int ha_stride,
                   const int* __restrict__ hull_b, int hull_width, int n, int iters,
                   int miss_max_t, float* __restrict__ out, int* __restrict__ work) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* rec = f + (size_t)r * NF;
  const float speed_bound = rec[33], max_t = rec[34];
  float hit_t = miss_max_t ? max_t : INF_T;
  int adv_iters = 0, gjk_iters = 0;
  if (ti[3 * r + 2] == 0) {  // no such target: done from the start
    out[r] = hit_t;
    if (work) work[2 * r] = work[2 * r + 1] = 0;
    return;
  }
  const Pool pool = {hull_x, hull_y, hull_z, hull_width};
  Ctx c;
  c.a = {ti[3 * r], params_a + (size_t)r * pa_stride, hull_a + (size_t)r * ha_stride};
  c.b = {ti[3 * r + 1], params_b + (size_t)r * 12, hull_b + (size_t)r * hull_width};
  const V3 a_pos = v3_at(rec, 0), a_vel = v3_at(rec, 7), a_omega = v3_at(rec, 10);
  const Q a_orn = q_at(rec, 3);
  const V3 o_pos = v3_at(rec, 13), o_vel = v3_at(rec, 20), o_omega = v3_at(rec, 23);
  const Q o_orn = q_at(rec, 16);
  const V3 lpos = v3_at(rec, 26);
  const Q lorn = q_at(rec, 29);
  float t = 0.0f;
  for (int it = 0; it < iters; ++it) {
    ++adv_iters;
    // Both poses at time t (sweeps.py _advance's ctx_at).
    const V3 pa = add(a_pos, scale(a_vel, t));
    const Q qa = integrate_orientation(a_orn, a_omega, t);
    const V3 ow_pos = add(o_pos, scale(o_vel, t));
    const Q ow_orn = integrate_orientation(o_orn, o_omega, t);
    const V3 pb = add(ow_pos, rotate(ow_orn, lpos));
    const Q qb = qmul(ow_orn, lorn);
    c.orn_ab = qmul(conj(qa), qb);
    c.pos_ab = rotate_inverse(qa, sub(pb, pa));
    const float dist = gjk_surface_distance(c, pool, &gjk_iters);
    if (dist < 1e-4f) {  // impact
      hit_t = t;
      break;
    }
    const float new_t = t + fmaxf(fmaxf(dist, 0.0f) / speed_bound, 1e-5f);
    if (new_t > max_t) break;  // a miss within max_t
    t = new_t;
  }
  out[r] = hit_t;
  if (work) {
    work[2 * r] = adv_iters;
    work[2 * r + 1] = gjk_iters;
  }
}

}  // namespace

extern "C" int conservative_advance_launch(const float* f, const int* ti, const float* params_a,
                                           int pa_stride, const float* params_b,
                                           const float* hull_x, const float* hull_y,
                                           const float* hull_z, const int* hull_a,
                                           int ha_stride, const int* hull_b, int hull_width,
                                           int n, int iters, int miss_max_t, float* out,
                                           int* work, void* stream) {
  if (n == 0) return 0;
  advance_kernel<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0, (cudaStream_t)stream>>>(
      f, ti, params_a, pa_stride, params_b, hull_x, hull_y, hull_z, hull_a, ha_stride, hull_b,
      hull_width, n, iters, miss_max_t, out, work);
  return (int)cudaGetLastError();
}
