// The wave walk of the cooperative contact kernels K1 (substeps_contacts.cu), K2
// (substeps_contacts_win.cu), K3 (contact_sweep.cu) and K4 (contact_sweep_win.cu): each
// block's plan read from the wave table, the cp.async staging of a slice's
// state-independent inputs, the fixed-order sums of its deltas, the size of a cooperative
// grid, and (namespace pages) the iteration pass over a page stream that K1 and K3 share.
//
// The wave table (solver/solve.py waves_by_key), int32 (2 n + 2,) for n slices: [0] the
// wave count W; [1 .. n + 1] each wave's first index into the live list, then the live
// count; [n + 2 ..] the live slices in ascending order, then -1. A wave of several slices
// is a run of one color c < C: its slices' valid rows touch pairwise distinct dynamic
// bodies, so they may run at once and give the in-order walk's result. A wave of one slice
// may share bodies with its neighbours (Jacobi and wide slices), and a run of such waves
// is walked in order by block 0 alone, the other blocks waiting at the grid barrier after
// it. Slices are never reordered.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "contact_rows.cuh"

namespace cg = cooperative_groups;

namespace {

// Shared-memory words of a plan over n slices (placed last in a kernel's shared memory).
__host__ __device__ constexpr size_t plan_words(int n) { return (size_t)6 * n + 6; }

struct Plan {
  int* jobs;    // this block's slices of one pass, in walk order (n)
  int* segn;    // per segment, how many of them (n + 1)
  int* sega;    // per segment, its first index into the live list (n + 1)
  int* segl;    // per segment, its slices: > 0 a wave dealt over the grid, < 0 a run of
                // one-slice waves walked in order by block 0 (n + 1)
  int* live;    // the live slices (n)
  int* counts;  // [0] segments, [1] jobs
};

__device__ Plan carve_plan(int* base, int n) {
  Plan m;
  m.jobs = base;
  m.segn = m.jobs + n;
  m.sega = m.segn + n + 1;
  m.segl = m.sega + n + 1;
  m.live = m.segl + n + 1;
  m.counts = m.live + n;
  return m;
}

// This block's plan for one pass, from the wave table: the segments (a wave of several
// slices, or a run of one-slice waves) and the slices it runs in each. A wave's slices go
// round-robin to the blocks (slice k of the wave to block k mod gridDim.x) (K2, K4), or
// with deal_rows (K1) no block takes a wave's slices as jobs and the kernel deals the
// wave's rows over the whole grid instead.
__device__ void plan(const int* waves, int n, const Plan& m, bool deal_rows) {
  int* ptr = m.sega;  // the wave starts, read once, overwritten below by thread 0 alone
  for (int i = threadIdx.x; i < n + 1; i += blockDim.x) ptr[i] = waves[1 + i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) m.live[i] = waves[n + 2 + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int W = waves[0];
    int w = 0, g = 0, j = 0;
    while (w < W) {
      const int a = ptr[w], b = ptr[w + 1];
      const int before = j;
      int len;
      if (b - a == 1) {  // a run of one-slice waves: block 0, in order
        int w2 = w;
        while (w2 < W && ptr[w2 + 1] - ptr[w2] == 1) ++w2;
        len = -(ptr[w2] - a);
        if (blockIdx.x == 0)
          for (int i = a; i < ptr[w2]; ++i) m.jobs[j++] = m.live[i];
        w = w2;
      } else {  // one color's wave
        len = b - a;
        if (!deal_rows)
          for (int k = blockIdx.x; k < b - a; k += gridDim.x) m.jobs[j++] = m.live[a + k];
        ++w;
      }
      // Segment g's start overwrites ptr[g] only after every ptr[w' <= w] was read (g <= w).
      m.sega[g] = a;
      m.segl[g] = len;
      m.segn[g++] = j - before;
    }
    m.counts[0] = g;
    m.counts[1] = j;
  }
  __syncthreads();
}

// Queue cp.async copies of `rows` rows of `w` 32-bit words, row k from src + k * stride
// words into dst + k * w words, 16 bytes per copy (w a multiple of 4, both ends 16-byte
// aligned). The caller commits the group.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t stride, int rows,
                                           int w) {
  const int w4 = w / 4;
  for (int k = threadIdx.x; k < rows * w4; k += blockDim.x) {
    const int c = k / w4, j = 4 * (k - c * w4);
    __pipeline_memcpy_async(dst + (size_t)c * w + j, src + (size_t)c * stride + j, 16);
  }
}

// The same for words e0 .. e0 + w of n (at most 4) arrays s0 .. s3, array a into dst + a *
// w, in one loop, each address made inside its branch: a loop per array cost K2 20 more
// bytes of register spills and ~4% of its time (tools/k2_vs_parent.py, H100).
__device__ __forceinline__ void stage_arrays(float* dst, int n, int w, size_t e0,
                                             const void* s0, const void* s1, const void* s2,
                                             const void* s3 = nullptr) {
  const int w4 = w / 4;
  for (int k = threadIdx.x; k < n * w4; k += blockDim.x) {
    const int a = k / w4, j = 4 * (k - a * w4);
    const void* src = a == 0 ? (const void*)(static_cast<const float*>(s0) + e0 + j)
                    : a == 1 ? (const void*)(static_cast<const float*>(s1) + e0 + j)
                    : a == 2 ? (const void*)(static_cast<const float*>(s2) + e0 + j)
                             : (const void*)(static_cast<const float*>(s3) + e0 + j);
    __pipeline_memcpy_async(dst + (size_t)a * w + j, src, 16);
  }
}

// Fixed-order sums of one slice's deltas (m2 entries: sb A sides, then sb B sides): pos[e]
// is entry e's body row in bg (row stride `stride` floats, 16-byte aligned), ord the
// slice's stable sort of the entries by position, D and V (m2 x 6) each entry's delta and
// the velocity its row read, wr[e] nonzero where entry e writes. The first entry of each
// position's run, when it writes, adds the whole run in ascending entry order onto the
// velocity its row read (a position is written by this slice alone, so that is the value
// the walk would hold), and stores it with two wide stores; a run whose first entry does
// not write is skipped. So every writing entry must come first in its run: K1's and K4's
// orders list the writing entries of a slice before the others (ops/sweep.py
// writer_order); K2's entries write exactly when their body has inertia, so every entry
// of a run writes or none does, and the plain stable sort serves.
__device__ __forceinline__ void sum_runs(float* bg, int stride, const int* pos, const int* ord,
                                         const float* D, const float* V, const int* wr, int m2) {
  for (int q = threadIdx.x; q < m2; q += blockDim.x) {
    const int b = pos[ord[q]];
    if (q > 0 && pos[ord[q - 1]] == b) continue;
    if (!wr[ord[q]]) continue;
    float acc[6];
    const float* v0 = V + (size_t)ord[q] * 6;
    for (int c = 0; c < 6; ++c) acc[c] = v0[c];
    for (int q2 = q; q2 < m2 && pos[ord[q2]] == b; ++q2) {
      const float* d = D + (size_t)ord[q2] * 6;
      for (int c = 0; c < 6; ++c) acc[c] += d[c];
    }
    float* g = bg + (size_t)b * stride;
    *reinterpret_cast<float4*>(g) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float2*>(g + 4) = make_float2(acc[4], acc[5]);
  }
}

// One row's writing sides stored straight to bg (K1's colored wave dealt by rows: no
// other row of the wave names a body this row writes). Side A's delta first, as the in-order
// sum adds them when both sides name one body.
__device__ __forceinline__ void store_row(float* bg, int stride, int ba, int bb, bool wa,
                                          bool wb, const float* va6, const float* vb6,
                                          const float* da, const float* db) {
  float acc[6];
  if (wa) {
    for (int c = 0; c < 6; ++c) acc[c] = va6[c] + da[c];
    if (wb && bb == ba)
      for (int c = 0; c < 6; ++c) acc[c] += db[c];
    float* g = bg + (size_t)ba * stride;
    *reinterpret_cast<float4*>(g) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float2*>(g + 4) = make_float2(acc[4], acc[5]);
  }
  if (wb && !(wa && bb == ba)) {
    for (int c = 0; c < 6; ++c) acc[c] = vb6[c] + db[c];
    float* g = bg + (size_t)bb * stride;
    *reinterpret_cast<float4*>(g) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float2*>(g + 4) = make_float2(acc[4], acc[5]);
  }
}

// The dynamic shared memory one block of the current card may use, in bytes.
inline cudaError_t smem_limit(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)optin;
  return err;
}

// Grid sizes of one kernel found so far, per device and dynamic shared-memory size: a
// kernel launched on banks of several shapes (K3 on a step's two banks) finds each once.
struct GridCache {
  static constexpr int N = 8;
  int n = 0;
  int dev[N];
  size_t smem[N];
  int blocks[N];
};

// Blocks of a cooperative grid of `kernel` at `threads` threads and `smem` bytes of dynamic
// shared memory: co-resident blocks per SM (the occupancy calculator, after raising the
// kernel's dynamic shared-memory limit to the largest size cached for the device) times
// the SMs, from `cache` after the first launch of a size. cudaErrorLaunchOutOfResources
// where `smem` is more than one block may use (the wrappers raise ValueError on it).
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, GridCache& cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int cached = cache.n < GridCache::N ? cache.n : GridCache::N;
  size_t attr = smem;
  for (int i = 0; i < cached; ++i) {
    if (cache.dev[i] != dev) continue;
    if (cache.smem[i] == smem) {
      *blocks = cache.blocks[i];
      return cudaSuccess;
    }
    if (cache.smem[i] > attr) attr = cache.smem[i];
  }
  int sms = 0, coop = 0, per_sm = 0;
  size_t limit = 0;
  err = smem_limit(&limit);
  if (err == cudaSuccess && smem > limit) err = cudaErrorLaunchOutOfResources;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  const int slot = cache.n++ % GridCache::N;
  cache.dev[slot] = dev;
  cache.smem[slot] = smem;
  cache.blocks[slot] = per_sm * sms;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// ---- the iteration pass over a page stream, shared by K1 and K3 --------------------------
// A bank of slices of sb rows in stream order: P has bg (n, 16) body rows, ps (32, B)
// prestep rows, imp (8, B) impulses, dep (4, B rows of stride B) depths, idx2 / scale /
// order (n_slices * 2 * sb), the ints B, sb and staged, and inv_h() the substep's 1 / h.
namespace pages {

// Shared memory, in 4-byte words: when staged, two stages of [prestep 32 sb | idx2 |
// scale | order (2 sb each)]; the deltas D and velocities V (2 sb x 6 each), the write
// flags (2 sb), then the plan.
__host__ __device__ constexpr size_t stage_words(int sb) { return (size_t)(PS_ROWS + 6) * sb; }
__host__ __device__ constexpr size_t smem_words(int sb, int n, bool staged) {
  return (staged ? 2 * stage_words(sb) : 0) + (size_t)26 * sb + plan_words(n);
}

struct Smem {
  float* stage[2];
  float* D; float* V; int* wr;
  Plan plan;
};

__device__ Smem carve(float* smem, int sb, int n, bool staged) {
  Smem m;
  m.stage[0] = smem;
  m.stage[1] = smem + (staged ? stage_words(sb) : 0);
  m.D = m.stage[1] + (staged ? stage_words(sb) : 0);
  m.V = m.D + (size_t)12 * sb;
  m.wr = reinterpret_cast<int*>(m.V + (size_t)12 * sb);
  m.plan = carve_plan(m.wr + 2 * sb, n);
  return m;
}

// Where one slice's state-independent inputs are read: a stage, or the bank.
struct SliceIn {
  const float* ps; int ps_stride, ps_col;  // prestep row k of row r: ps[k * stride + col + r]
  const int* idx; const float* sc; const int* ord;  // 2 sb entries each
};

__device__ SliceIn staged_in(const float* st, int sb) {
  const int* idx = reinterpret_cast<const int*>(st + (size_t)PS_ROWS * sb);
  const float* sc = reinterpret_cast<const float*>(idx + 2 * sb);
  return {st, sb, 0, idx, sc, reinterpret_cast<const int*>(sc + 2 * sb)};
}

template <typename P>
__device__ SliceIn bank_in(const P& p, int sl) {
  const size_t e0 = (size_t)sl * 2 * p.sb;
  return {p.ps, p.B, sl * p.sb, p.idx2 + e0, p.scale + e0, p.order + e0};
}

// Copy slice sl's state-independent inputs into a stage, 16 bytes per copy.
template <typename P>
__device__ void stage_slice(const P& p, float* st, int sl) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  stage_rows(st, p.ps + (size_t)sl * sb, p.B, PS_ROWS, sb);
  stage_arrays(st + (size_t)PS_ROWS * sb, 3, 2 * sb, e0, p.idx2, p.scale, p.order);
  __pipeline_commit();
}

// One live slice of warm start (solve = false) or of one velocity iteration: rows
// (contact_rows.cuh body_row), then each body's run summed in the slice's writer-first
// stable sort (sum_runs).
template <typename P>
__device__ void run_slice(const P& p, const Smem& m, const SliceIn& in, int sl, bool solve) {
  const int sb = p.sb;
  for (int r = threadIdx.x; r < sb; r += blockDim.x) {
    bool still_a, still_b;
    body_row(p.bg, in.ps, in.ps_stride, in.ps_col + r, p.imp, p.dep, p.B, sl * sb + r,
             in.idx[r], in.idx[sb + r], in.sc[r], in.sc[sb + r], solve, p.inv_h(),
             m.D + (size_t)r * 6, m.D + (size_t)(sb + r) * 6, m.V + (size_t)r * 6,
             m.V + (size_t)(sb + r) * 6, &still_a, &still_b);
    const bool valid = in.ps[(size_t)PS_VALID * in.ps_stride + in.ps_col + r] > 0.5f;
    m.wr[r] = valid && !still_a;
    m.wr[sb + r] = valid && !still_b;
  }
  __syncthreads();
  sum_runs(p.bg, 16, in.idx, in.ord, m.D, m.V, m.wr, 2 * sb);
}

// One row of a colored wave dealt over the grid: inputs read from the bank, the writing
// sides stored straight.
template <typename P>
__device__ void run_row(const P& p, int sl, int r, bool solve) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  const int ba = p.idx2[e0 + r], bb = p.idx2[e0 + sb + r];
  const int col = sl * sb + r;
  float da[6], db[6], va6[6], vb6[6];
  bool still_a, still_b;
  body_row(p.bg, p.ps, p.B, col, p.imp, p.dep, p.B, col, ba, bb, p.scale[e0 + r],
           p.scale[e0 + sb + r], solve, p.inv_h(), da, db, va6, vb6, &still_a, &still_b);
  const bool valid = p.ps[(size_t)PS_VALID * p.B + col] > 0.5f;
  store_row(p.bg, 16, ba, bb, valid && !still_a, valid && !still_b, va6, vb6, da, db);
}

// What a block keeps in registers across its passes, read once after plan(): its plan's
// segment and job counts, the rows of a slice, and its place in the grid.
struct Walk {
  int nseg, njobs, sb, gtid, gstride;
};

__device__ __forceinline__ Walk walk_of(const Plan& plan, int sb) {
  return {plan.counts[0], plan.counts[1], sb, (int)(blockIdx.x * blockDim.x + threadIdx.x),
          (int)(gridDim.x * blockDim.x)};
}

// One pass over every wave of the plan, warm start (solve false) or one velocity
// iteration. A color's wave has its rows dealt over every thread of the grid, a row per
// thread, its writing sides stored straight (deal_rows, with a plan made by rows), or its
// slices dealt to the blocks (a plan made by slices); Jacobi and other one-slice waves run
// in order on block 0. A block walking slices stages its next one's inputs (when staged)
// while it solves this one. One grid barrier after each segment. `buf` (an int lvalue) is
// the block's current stage, carried across passes; the caller stages the plan's first
// job before the first pass. A macro, expanded in the kernel: as a function (force-inlined
// or not, its arguments by reference or by value) nvcc compiled K1 0.7-4% slower than with
// the loop written in the kernel; expanded, with the slice size read once into the walk,
// it compiles to the parent K1's SASS and time (PERF.md).
#define PAGES_PASS(deal_rows, p, m, w, grid, solve, buf)                                      \
  do {                                                                                        \
    const int pp_sb = (w).sb, pp_njobs = (w).njobs;                                           \
    const int* pp_jobs = (m).plan.jobs;                                                       \
    int pp_j = 0;                                                                             \
    for (int pp_g = 0; pp_g < (w).nseg; ++pp_g) {                                             \
      const int pp_len = (m).plan.segl[pp_g];                                                 \
      if ((deal_rows) && pp_len > 0) { /* a color's wave: its rows over the grid */           \
        const int pp_a = (m).plan.sega[pp_g];                                                 \
        for (int pp_q = (w).gtid; pp_q < pp_len * pp_sb; pp_q += (w).gstride)                 \
          pages::run_row(p, (m).plan.live[pp_a + pp_q / pp_sb], pp_q % pp_sb, solve);         \
      } else { /* this block's slices of the segment, in order */                             \
        for (int pp_t = 0; pp_t < (m).plan.segn[pp_g]; ++pp_t, ++pp_j) {                      \
          if ((p).staged) __pipeline_wait_prior(0);                                           \
          __syncthreads(); /* this stage landed; the previous slice is done with the other */ \
          if ((p).staged)                                                                     \
            pages::stage_slice(p, (m).stage[(buf) ^ 1],                                       \
                               pp_jobs[pp_j + 1 < pp_njobs ? pp_j + 1 : 0]);                  \
          pages::run_slice(p, m,                                                              \
                           (p).staged ? pages::staged_in((m).stage[buf], pp_sb)               \
                                      : pages::bank_in(p, pp_jobs[pp_j]),                     \
                           pp_jobs[pp_j], solve);                                             \
          (buf) ^= (p).staged;                                                                \
        }                                                                                     \
      }                                                                                       \
      (grid).sync();                                                                          \
    }                                                                                         \
  } while (0)

// Whether the two stages fit beside the rest in one block's shared memory (pages of up
// to 512 rows on the H100; larger pages are read from the bank).
inline cudaError_t staged_fits(int sb, int n_slices, bool* staged) {
  size_t limit = 0;
  const cudaError_t err = smem_limit(&limit);
  *staged = smem_words(sb, n_slices, true) * 4 <= limit;
  return err;
}

}  // namespace pages

}  // namespace
