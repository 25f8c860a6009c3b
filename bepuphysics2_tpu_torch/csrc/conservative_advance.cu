// K8: conservative advancement to the time of impact over factored records, in two
// passes, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes this loop in XLA, which compiles its
// fori_loop of gjk_closest into one device loop (bepuphysics2_tpu/collision/sweeps.py:
// sweep_shape_all's advancement and pair_toi's _advance). This kernel runs
// collision/sweeps.py _advance, with collision/convex.py's support mappings and
// gjk_closest inlined, over records that name a row of an A table (the swept side) and a
// row of a B table (the target):
//
//   pass 1, one thread a record: the first advancement iteration (at t = 0). A record
//     that ends there (no target, an impact at t = 0, a miss within max_t) writes its
//     output; every other one is appended to a queue in global memory (one atomicAdd a
//     warp: a ballot, the leader adds the warp's count, each lane its rank).
//   pass 2, a persistent grid of a few blocks an SM: each lane carries one queued record
//     (its id, t and iteration count in registers) one advancement iteration at a time;
//     when the record ends the lane writes its output and takes the next queued record
//     (one atomicAdd on the queue's head a warp). A warp so waits for its slowest lane's
//     advancement iteration, not for its slowest record's whole loop.
//
// What bounds it: operations. The tables are a few MB (phase 33's call of 3,170,304
// records reads 12,384 target rows and 256 sweep rows); each record runs up to `iters`
// GJK calls of up to 24 iterations, each a distance subalgorithm over 4 vertices, 6
// edges and 4 faces (~600 flops) and two support mappings; a hull's support walks its
// pool rows. A record costs what it needs: it stops at its impact or miss, as the masked
// version's result stops changing there. The queue's order is the atomics' and differs
// from run to run; each record runs the same arithmetic whatever lane or pass takes it,
// so the output does not (atomics index the queue only, no float is summed by them).
// The GJK simplex lives in registers: every array is indexed by constants after
// unrolling, and a new vertex goes to its slot by four selects.
//
// Rounding: every operation is written in the plain version's order (utils/vec.py's
// formulas, left to right), and the file is built with -fmad=false (ops/build.py), so
// no multiply-add is contracted: each operation rounds as one PyTorch op does. sinf,
// cosf, sqrtf and division are the IEEE-rounded ones PyTorch's CUDA ops call. The speed
// bound is computed here in sweeps.py gather_records' order.
//
// Layouts: a table is structure-of-arrays, float32 column c of row j at f[c * rows + j]:
// position 0-2, orientation 3-6 (x, y, z, w), velocity 7-9, angular velocity 10-12, the
// radius of the speed bound 13, packed params 14-25; a B table adds the target's pose in
// its owner's frame, position 26-28 and orientation 29-32. Its int32 columns i[c * rows +
// j]: type 0, registry row into hull_rows 1 (-1: none), exists 2 (B tables). Records:
// with pairs null, every A row against every B row, record r = (r / nb, r % nb) and
// exists from B; else pairs (n, 2) int32 (A row, B row) and exists (n,) bytes. hull_rows
// (S, H) int32 pool rows (-1 padded); hull_x/y/z (P,) the pool. out (n,): the time of
// impact, or the miss value (3e38, or max_t where miss_max_t is 1). work (n, 2) int32, or
// null: the advancement and GJK iterations each record ran (the work its data needs, for
// a measurement's bound). queue (n, 2) int32 scratch; counters (2,) int32: the queue's
// length and head, zeroed here (cudaMemsetAsync on the stream).

#include <cuda_runtime.h>

// How a pass is launched; a host build of this file (tools/k8_host_check.py) defines it
// as a loop.
#ifndef K8_LAUNCH
#define K8_LAUNCH(kernel, blocks, args, stream) \
  kernel<<<(blocks), NTHREADS, 0, (cudaStream_t)(stream)>>>(args)
#endif

namespace {

constexpr int NTHREADS = 128;
constexpr int GJK_ITERS = 24;
constexpr unsigned FULL_MASK = 0xffffffffu;
// shapes/registry.py's type ids.
constexpr int SPHERE = 0, CAPSULE = 1, TRIANGLE = 3, CYLINDER = 4, CONVEX_HULL = 5;
constexpr float INF_T = 3.0e38f;
// Table columns (collision/sweeps.py A_COLS, B_COLS, the int columns).
constexpr int C_POS = 0, C_ORN = 3, C_VEL = 7, C_OMEGA = 10, C_RADIUS = 13, C_PARAMS = 14,
              C_LPOS = 26, C_LORN = 29;
constexpr int I_TYPE = 0, I_HULL = 1, I_EXISTS = 2;

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
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }

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
__device__ __forceinline__ float length(V3 v) { return sqrtf(dot(v, v)); }

// utils/vec.py integrate_orientation.
__device__ __forceinline__ Q integrate_orientation(Q orn, V3 omega, float dt) {
  const float speed = length(omega);
  const float half = speed * dt * 0.5f;
  const bool spins = speed > 1e-15f;
  const float s = spins ? sinf(half) / fmaxf(speed, 1e-15f) : 0.0f;
  const Q dq = {omega.x * s, omega.y * s, omega.z * s, cosf(half)};
  const Q m = qmul(dq, orn);
  const float inv = 1.0f / sqrtf(m.x * m.x + m.y * m.y + m.z * m.z + m.w * m.w);
  const Q out = {m.x * inv, m.y * inv, m.z * inv, m.w * inv};
  return spins ? out : orn;
}

// One side of a record: its type, packed params (column k at p[k * stride]) and its
// shape's hull pool rows (null: none).
struct Side {
  int type;
  const float* p;
  int stride;
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
  const int k = s.stride;
  *margin = (s.type == SPHERE || s.type == CAPSULE) ? p[0] : 0.0f;
  switch (s.type) {
    case SPHERE:
      return {0.0f, 0.0f, 0.0f};
    case CAPSULE:
      return {0.0f, d.y >= 0.0f ? p[k] : -p[k], 0.0f};
    case CYLINDER: {
      const float horiz = sqrtf(d.x * d.x + d.z * d.z);
      const float inv_h = horiz > 1e-12f ? 1.0f / fmaxf(horiz, 1e-12f) : 0.0f;
      return {d.x * inv_h * p[0], d.y >= 0.0f ? p[k] : -p[k], d.z * inv_h * p[0]};
    }
    case TRIANGLE: {
      const V3 va = {p[0], p[k], p[2 * k]}, vb = {p[3 * k], p[4 * k], p[5 * k]},
               vc = {p[6 * k], p[7 * k], p[8 * k]};
      const float da = dot(d, va), db = dot(d, vb), dc = dot(d, vc);
      return (da >= db && da >= dc) ? va : (db >= dc ? vb : vc);
    }
    case CONVEX_HULL: {
      // The first maximal vertex of the shape's pool rows (-1 rows rank last).
      int best_row = -1;
      float best_dot = 0.0f;
      for (int j = 0; j < pool.width; ++j) {
        const int r = s.hull ? s.hull[j] : -1;
        const float v = r >= 0 ? d.x * pool.x[r] + d.y * pool.y[r] + d.z * pool.z[r]
                               : -3.0e38f;
        if (j == 0 || v > best_dot) {
          best_row = r;
          best_dot = v;
        }
      }
      const int r = max(best_row, 0);
      return {pool.x[r], pool.y[r], pool.z[r]};
    }
    default:  // the box, and the plain version's fallback for any other type
      return {d.x >= 0.0f ? p[0] : -p[0], d.y >= 0.0f ? p[k] : -p[k],
              d.z >= 0.0f ? p[2 * k] : -p[2 * k]};
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
// strictly nearer. keep: bit k set where the nearest feature keeps point k. Every loop
// has constant bounds and is unrolled, so pts and bary are registers.
__device__ __forceinline__ V3 closest_on_simplex(const V3 (&pts)[4], int mask, int* keep) {
  float best_d2 = 3.0e38f;
  float bary[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int best_keep = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d2 = dot(pts[i], pts[i]);
    if (((mask >> i) & 1) && d2 < best_d2) {
      best_d2 = d2;
#pragma unroll
      for (int k = 0; k < 4; ++k) bary[k] = k == i ? 1.0f : 0.0f;
      best_keep = 1 << i;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
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
#pragma unroll
        for (int k = 0; k < 4; ++k) bary[k] = k == i ? 1.0f - t : (k == j ? t : 0.0f);
        best_keep = (1 << i) | (1 << j);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i + 1; j < 4; ++j) {
#pragma unroll
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
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bary[q] = q == i ? u : (q == j ? v : (q == k ? w : 0.0f));
          best_keep = (1 << i) | (1 << j) | (1 << k);
        }
      }
    }
  }
  *keep = best_keep;
  V3 out = {0.0f, 0.0f, 0.0f};
#pragma unroll
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
__device__ __forceinline__ float gjk_surface_distance(const Ctx& c, const Pool& pool,
                                                      int* gjk_iters) {
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
    // w goes into the first slot the nearest feature does not keep (slot 0 if it keeps
    // all four), written by selects: a runtime index would put pts in local memory.
    const bool f0 = !(keep & 1), f1 = !(keep & 2), f2 = !(keep & 4), f3 = !(keep & 8);
    const bool w1 = !f0 && f1, w2 = !f0 && !f1 && f2, w3 = !f0 && !f1 && !f2 && f3;
    const bool w0 = !w1 && !w2 && !w3;
    pts[0] = pick(w0, w, pts[0]);
    pts[1] = pick(w1, w, pts[1]);
    pts[2] = pick(w2, w, pts[2]);
    pts[3] = pick(w3, w, pts[3]);
    mask = keep | (w0 ? 1 : 0) | (w1 ? 2 : 0) | (w2 ? 4 : 0) | (w3 ? 8 : 0);
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

// Everything a pass reads: the tables, the records and the outputs.
struct Args {
  const float* a_f;
  const int* a_i;
  int na;
  const float* b_f;
  const int* b_i;
  int nb;
  const int* pairs;
  const unsigned char* exists;
  int n;
  const int* hull_rows;
  int hull_width;
  const float *hull_x, *hull_y, *hull_z;
  float max_t;
  int iters;
  int miss_max_t;
  float* out;
  int* work;
  int2* queue;
  int* counters;  // [0] the queue's length, [1] its head
};

// One record's inputs, loaded once into registers.
struct Rec {
  Side a, b;
  V3 a_pos, a_vel, a_omega, o_pos, o_vel, o_omega, lpos;
  Q a_orn, o_orn, lorn;
  float speed_bound;
};

// The record's A and B rows and whether it has a target.
__device__ __forceinline__ bool resolve(const Args& g, int r, int* ia, int* ib) {
  if (g.pairs) {
    *ia = g.pairs[2 * r];
    *ib = g.pairs[2 * r + 1];
    return g.exists[r] != 0;
  }
  *ia = r / g.nb;
  *ib = r - *ia * g.nb;
  return g.b_i[I_EXISTS * g.nb + *ib] != 0;
}

__device__ __forceinline__ V3 v3_col(const float* f, int rows, int c, int j) {
  return {f[c * rows + j], f[(c + 1) * rows + j], f[(c + 2) * rows + j]};
}
__device__ __forceinline__ Q q_col(const float* f, int rows, int c, int j) {
  return {f[c * rows + j], f[(c + 1) * rows + j], f[(c + 2) * rows + j],
          f[(c + 3) * rows + j]};
}

__device__ __forceinline__ Side side_of(const Args& g, const float* f, const int* i, int rows,
                                        int j) {
  const int row = i[I_HULL * rows + j];
  return {i[I_TYPE * rows + j], f + C_PARAMS * rows + j, rows,
          row >= 0 ? g.hull_rows + (size_t)row * g.hull_width : nullptr};
}

// The speed bound is sweeps.py's: |v_a - v_b| + |w_a| r_a + |w_b| r_b + 1e-6, left to right.
__device__ __forceinline__ Rec load_record(const Args& g, int ia, int ib) {
  Rec c;
  c.a = side_of(g, g.a_f, g.a_i, g.na, ia);
  c.b = side_of(g, g.b_f, g.b_i, g.nb, ib);
  c.a_pos = v3_col(g.a_f, g.na, C_POS, ia);
  c.a_orn = q_col(g.a_f, g.na, C_ORN, ia);
  c.a_vel = v3_col(g.a_f, g.na, C_VEL, ia);
  c.a_omega = v3_col(g.a_f, g.na, C_OMEGA, ia);
  c.o_pos = v3_col(g.b_f, g.nb, C_POS, ib);
  c.o_orn = q_col(g.b_f, g.nb, C_ORN, ib);
  c.o_vel = v3_col(g.b_f, g.nb, C_VEL, ib);
  c.o_omega = v3_col(g.b_f, g.nb, C_OMEGA, ib);
  c.lpos = v3_col(g.b_f, g.nb, C_LPOS, ib);
  c.lorn = q_col(g.b_f, g.nb, C_LORN, ib);
  const float ra = g.a_f[C_RADIUS * g.na + ia], rb = g.b_f[C_RADIUS * g.nb + ib];
  c.speed_bound = length(sub(c.a_vel, c.o_vel)) + length(c.a_omega) * ra +
                  length(c.o_omega) * rb + 1e-6f;
  return c;
}

// The surface distance at time t (sweeps.py _advance's ctx_at, then GJK).
__device__ __forceinline__ float distance_at(const Rec& c, const Pool& pool, float t,
                                             int* gjk_iters) {
  const V3 pa = add(c.a_pos, scale(c.a_vel, t));
  const Q qa = integrate_orientation(c.a_orn, c.a_omega, t);
  const V3 ow_pos = add(c.o_pos, scale(c.o_vel, t));
  const Q ow_orn = integrate_orientation(c.o_orn, c.o_omega, t);
  const V3 pb = add(ow_pos, rotate(ow_orn, c.lpos));
  const Q qb = qmul(ow_orn, c.lorn);
  Ctx x;
  x.a = c.a;
  x.b = c.b;
  x.orn_ab = qmul(conj(qa), qb);
  x.pos_ab = rotate_inverse(qa, sub(pb, pa));
  return gjk_surface_distance(x, pool, gjk_iters);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// One atomicAdd for the warp's lanes that ask (`want`): each gets base + its rank.
__device__ __forceinline__ int warp_claim(bool want, int* counter) {
  const unsigned m = __ballot_sync(FULL_MASK, want);
  if (!m) return 0;
  const int lane = lane_id(), leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(FULL_MASK, base, leader);
  return base + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(NTHREADS) advance_first(const Args g) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool queued = false;
  float t_next = 0.0f;
  if (r < g.n) {
    int ia, ib;
    const bool exists = resolve(g, r, &ia, &ib);
    float hit_t = g.miss_max_t ? g.max_t : INF_T;
    int adv_iters = 0, gjk_iters = 0;
    if (exists && g.iters > 0) {
      const Pool pool = {g.hull_x, g.hull_y, g.hull_z, g.hull_width};
      const Rec c = load_record(g, ia, ib);
      const float t = 0.0f;
      adv_iters = 1;
      const float dist = distance_at(c, pool, t, &gjk_iters);
      if (dist < 1e-4f) {  // impact
        hit_t = t;
      } else {
        const float new_t = t + fmaxf(fmaxf(dist, 0.0f) / c.speed_bound, 1e-5f);
        // Not a miss within max_t, and iterations left: pass 2 carries it on.
        queued = !(new_t > g.max_t) && g.iters > 1;
        t_next = new_t;
      }
    }
    if (!queued) {
      g.out[r] = hit_t;
      if (g.work) {
        g.work[2 * r] = adv_iters;
        g.work[2 * r + 1] = gjk_iters;
      }
    } else if (g.work) {
      g.work[2 * r + 1] = gjk_iters;  // pass 2 adds its own
    }
  }
  const int slot = warp_claim(queued, &g.counters[0]);
  if (queued) g.queue[slot] = make_int2(r, __float_as_int(t_next));
}

__global__ void __launch_bounds__(NTHREADS) advance_rest(const Args g) {
  const int total = g.counters[0];
  const Pool pool = {g.hull_x, g.hull_y, g.hull_z, g.hull_width};
  const float miss = g.miss_max_t ? g.max_t : INF_T;
  int r = -1, it = 0, gjk_iters = 0;
  float t = 0.0f;
  bool drained = false;
  Rec c;
  for (;;) {
    const bool want = r < 0 && !drained;
    const int q = warp_claim(want, &g.counters[1]);
    if (want) {
      if (q < total) {
        const int2 e = g.queue[q];
        r = e.x;
        t = __int_as_float(e.y);
        it = 1;  // pass 1 ran the first iteration
        int ia, ib;
        resolve(g, r, &ia, &ib);
        c = load_record(g, ia, ib);
        gjk_iters = g.work ? g.work[2 * r + 1] : 0;
      } else {
        drained = true;
      }
    }
    if (!__any_sync(FULL_MASK, r >= 0)) break;
    if (r >= 0) {
      ++it;
      float hit_t = miss;
      bool ends = false;
      const float dist = distance_at(c, pool, t, &gjk_iters);
      if (dist < 1e-4f) {  // impact
        hit_t = t;
        ends = true;
      } else {
        const float new_t = t + fmaxf(fmaxf(dist, 0.0f) / c.speed_bound, 1e-5f);
        if (new_t > g.max_t) {  // a miss within max_t
          ends = true;
        } else {
          t = new_t;
          ends = it >= g.iters;
        }
      }
      if (ends) {
        g.out[r] = hit_t;
        if (g.work) {
          g.work[2 * r] = it;
          g.work[2 * r + 1] = gjk_iters;
        }
        r = -1;
      }
    }
  }
}

// Pass 2's grid: as many blocks as fit on the card at once.
int rest_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, advance_rest, NTHREADS, 0);
    cached[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// passes: 1 pass 1 alone (the counters zeroed first), 2 pass 2 alone over the queue pass
// 1 left (its head zeroed first), 3 both: one call of the kernel.
extern "C" int conservative_advance_launch(
    const float* a_f, const int* a_i, int na, const float* b_f, const int* b_i, int nb,
    const int* pairs, const unsigned char* exists, int n, const int* hull_rows,
    int hull_width, const float* hull_x, const float* hull_y, const float* hull_z,
    float max_t, int iters, int miss_max_t, float* out, int* work, int* queue,
    int* counters, int passes, void* stream) {
  if (n == 0) return 0;
  const Args g = {a_f, a_i, na, b_f, b_i, nb, pairs, exists, n, hull_rows, hull_width,
                  hull_x, hull_y, hull_z, max_t, iters, miss_max_t, out, work,
                  reinterpret_cast<int2*>(queue), counters};
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    K8_LAUNCH(advance_first, (n + NTHREADS - 1) / NTHREADS, g, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    if (!(passes & 1)) {
      err = cudaMemsetAsync(counters + 1, 0, sizeof(int), (cudaStream_t)stream);
      if (err != cudaSuccess) return (int)err;
    }
    K8_LAUNCH(advance_rest, rest_blocks(), g, stream);
    err = cudaGetLastError();
  }
  return (int)err;
}
