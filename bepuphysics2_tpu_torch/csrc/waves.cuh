// The wave walk of the cooperative contact kernels K1 (substeps_contacts.cu), K2
// (substeps_contacts_win.cu) and K4 (contact_sweep_win.cu): each block's plan read from
// the wave table, the cp.async staging of a slice's state-independent inputs, the
// fixed-order sums of its deltas, and the size of a cooperative grid.
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

// Blocks of a cooperative grid of `kernel` at `threads` threads and `smem` bytes of dynamic
// shared memory: co-resident blocks per SM (the occupancy calculator, after raising the
// kernel's dynamic shared-memory limit) times the SMs. Cached per kernel and size by the
// caller's `cache` (smem, blocks). cudaErrorLaunchOutOfResources where `smem` is more than
// one block may use (the wrappers raise ValueError on it).
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, size_t cache[2], int* blocks) {
  if (cache[0] == smem && cache[1] > 0) {
    *blocks = (int)cache[1];
    return cudaSuccess;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err == cudaSuccess && smem > limit) err = cudaErrorLaunchOutOfResources;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  cache[0] = smem;
  cache[1] = (size_t)per_sm * sms;
  *blocks = (int)cache[1];
  return cudaSuccess;
}

}  // namespace
