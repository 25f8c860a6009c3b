// K5: the passes of the TPU sweep prototypes with the body state held on chip, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of experiments/pallas_sweep_proto.py::pallas_sweep (v1,
// sweep_kernel), pallas_sweep_proto2.py::build (v2, make_kernel, modes A-D),
// pallas_sweep_proto3.py::pallas_sweep (v3, kernel) and pallas_sweep_proto4.py::
// pallas_sweep (v4, kernel). Each pass p gathers the (8,) rows of the bodies idx[p, :],
// runs the probes' fixed arithmetic on them (math_block: x = g*1.0001 + 0.1, six times
// x = x*1.1 - 0.25*x, d = x - g) and adds each row's d back onto its body; a body named
// twice in a pass takes the sum of its rows' deltas (the TPU's one-hot matmul sums them).
// Mode C (v2's gather-only variant) drops the scatter and adds 1e-30 times the sum of the
// pass's deltas to state[0, 0]; mode D (v2's lane-select-free variant) gathers component
// 0 of bodies (b/L)*L .. (b/L)*L + 7 instead of body b.
//
// What bounds it: latency. The passes depend on each other, and each is a gather, ~170
// flops per row and a scatter, so the critical path is 36 passes of shared-memory
// latency and barriers. The card's own bounds are far below: the bytes (state in and out,
// the indices: 0.41 MB at NB 4,096, M 1,024, 36 passes) take ~0.12 us at 3.35 TB/s, the
// ~6.5 MFLOP ~0.1 us at 67 TFLOP/s.
//
// Design: what the TPU prototypes kept in VMEM stays in shared memory. ONE block of 1,024
// threads loads the whole state, (NB, 8) f32 (128 KB at 4,096 bodies), from the caller's
// layout once (chunk-major body by body: eight coalesced loads in flight and two 16-byte
// shared stores a body; transposed element by element), walks the passes in order and
// writes the state back in the same layout at the end: it uses one SM of 132, as the TPU
// probe used one core, and its time per pass is the floor of a one-block walk. Per pass:
// - the pass's body list, its stable sort and its distinct flag were copied into one of
//   two shared-memory stages with cp.async while the pass before ran, so no pass waits on
//   device memory; one barrier starts the pass;
// - when the wrapper flagged the pass's bodies pairwise distinct and the mode reads only
//   the row's own body (the sweep: v1, v2 A and B, v3, v4), each thread reads its body's
//   row as two 16-byte loads, computes and writes S + d back from registers: no deltas
//   in shared memory, no second barrier;
// - otherwise (repeated bodies, mode D) every thread writes its row's deltas to shared
//   memory (component-major, conflict-free), a barrier, then the first entry of each
//   body's run in the pass's stable sort adds the whole run in ascending row order, so
//   repeated indices sum deterministically without float atomics; mode C sums its deltas
//   by warp shuffles, then the warps in order, and thread 0 adds the sum to state[0, 0].
// Both give S + d in the walk's order, so both give the same bits. The arithmetic uses
// __fmul_rn/__fadd_rn/__fsub_rn so that nvcc contracts nothing into an FMA: a pass
// without repeated indices gives the plain version's bits.
//
// K5_PARTS (compile time, default 7) leaves parts of a one-writer pass out, to split a
// pass's time (tools/k2_vs_parent.py --kernel k5 --breakdown): bit 2 the gather, bit 0 the
// math (without it d = g), bit 1 the scatter; a left-out scatter keeps its deltas in a sum
// that the compiler cannot drop.
//
// Layouts (f32, row-major), for NB bodies and a chunk width L (`lanes`):
//   chunk-major (v1, v2; L = 128)  (NB/L, 8L), component c of body b at
//                                  (b/L)*8L + c*L + b%L
//   transposed (v3 L = 128, v4 L = 8)  (8L, NB/L), at (c*L + b%L)*(NB/L) + b/L
//   idx, order (passes, M) int32: each pass's body list and its stable sort
//   distinct   (passes,) int32: the pass's bodies are pairwise distinct

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#ifndef K5_PARTS
#define K5_PARTS 7
#endif

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MODE_SWEEP = 0, MODE_GATHER_ONLY = 1, MODE_NO_LANE_SELECT = 2;
constexpr bool GATHER = K5_PARTS & 4, MATH = K5_PARTS & 1, SCATTER = K5_PARTS & 2;

struct Params {
  const float* vin; float* vout; const int* idx; const int* order; const int* distinct;
  int nb, m, passes, lanes, transposed, mode;
};

// Shared memory, in 4-byte words: the state (nb x 8), a pass's deltas (8 x m), two stages
// of [body list | stable sort (m each) | distinct flag, 3 unused], the warp sums.
__host__ __device__ constexpr size_t stage_words(int m) { return (size_t)2 * m + 4; }
__host__ __device__ constexpr size_t smem_words(int nb, int m) {
  return (size_t)nb * 8 + (size_t)m * 8 + 2 * stage_words(m) + NWARPS;
}

// Element (b, c) of the chunk-major layout.
__device__ __forceinline__ size_t chunk_at(const Params& p, int b, int c) {
  return (size_t)(b / p.lanes) * 8 * p.lanes + (size_t)c * p.lanes + b % p.lanes;
}

// Body b and component c of element i of the caller's layout.
__device__ __forceinline__ void body_comp(const Params& p, int i, int& b, int& c) {
  const int L = p.lanes;
  if (p.transposed) {
    const int nch = p.nb / L, row = i / nch, k = i - row * nch;
    c = row / L;
    b = k * L + (row - c * L);
  } else {
    const int k = i / (8 * L), r = i - k * 8 * L;
    c = r / L;
    b = k * L + (r - c * L);
  }
}

__device__ __forceinline__ float math_block(float g) {
  float x = __fadd_rn(__fmul_rn(g, 1.0001f), 0.1f);
  for (int k = 0; k < 6; ++k) x = __fsub_rn(__fmul_rn(x, 1.1f), __fmul_rn(0.25f, x));
  return __fsub_rn(x, g);
}

// Queue pass `pass`'s body list, sort and distinct flag into stage `st`, 4 bytes a copy.
__device__ __forceinline__ void stage_pass(const Params& p, int* st, int pass) {
  const size_t e0 = (size_t)pass * p.m;
  for (int r = threadIdx.x; r < p.m; r += blockDim.x) {
    __pipeline_memcpy_async(st + r, p.idx + e0 + r, 4);
    __pipeline_memcpy_async(st + p.m + r, p.order + e0 + r, 4);
  }
  if (threadIdx.x == 0) __pipeline_memcpy_async(st + 2 * p.m, p.distinct + pass, 4);
  __pipeline_commit();
}

__global__ void __launch_bounds__(NTHREADS) probe_sweep_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                   // (nb, 8) body state
  float* D = S + (size_t)p.nb * 8;                   // (8, m) deltas of the pass
  int* stage[2];
  stage[0] = reinterpret_cast<int*>(D + (size_t)p.m * 8);
  stage[1] = stage[0] + stage_words(p.m);
  float* red = reinterpret_cast<float*>(stage[1] + stage_words(p.m));  // (NWARPS,)
  const int n = p.nb * 8, m = p.m;
  if (p.transposed) {  // element by element: coalesced loads, 8 in flight
#pragma unroll 8
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int b, c;
      body_comp(p, i, b, c);
      S[b * 8 + c] = p.vin[i];
    }
  } else {  // body by body: 8 coalesced loads in flight, a row's two 16-byte stores
    for (int b = threadIdx.x; b < p.nb; b += blockDim.x) {
      float g[8];
      for (int c = 0; c < 8; ++c) g[c] = p.vin[chunk_at(p, b, c)];
      float4* row = reinterpret_cast<float4*>(S + (size_t)b * 8);
      row[0] = make_float4(g[0], g[1], g[2], g[3]);
      row[1] = make_float4(g[4], g[5], g[6], g[7]);
    }
  }
  if (p.passes > 0) stage_pass(p, stage[0], 0);
  float sink = 0.0f;  // what a left-out part would have written (K5_PARTS)
  for (int pass = 0; pass < p.passes; ++pass) {
    const int* sidx = stage[pass & 1];
    const int* sord = sidx + m;
    __pipeline_wait_prior(0);
    __syncthreads();  // this pass's stage landed; the pass before is done with the other
    if (pass + 1 < p.passes) stage_pass(p, stage[(pass + 1) & 1], pass + 1);
    if (p.mode == MODE_SWEEP && sidx[2 * m]) {  // one writer per body: S + d from registers
      for (int r = threadIdx.x; r < m; r += blockDim.x) {
        const int b = sidx[r];
        if (!GATHER) {
          sink = __fadd_rn(sink, (float)b);
          continue;
        }
        if (b < 0 || b >= p.nb) continue;  // outside the state: the row moves nothing
        float4* row = reinterpret_cast<float4*>(S + (size_t)b * 8);
        const float4 lo = row[0], hi = row[1];
        float g[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        for (int c = 0; c < 8; ++c) {
          const float d = MATH ? math_block(g[c]) : g[c];
          if (SCATTER)
            g[c] = __fadd_rn(g[c], d);
          else
            sink = __fadd_rn(sink, d);
        }
        if (SCATTER) {
          row[0] = make_float4(g[0], g[1], g[2], g[3]);
          row[1] = make_float4(g[4], g[5], g[6], g[7]);
        }
      }
      continue;
    }
    float part = 0.0f;
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      const int b = sidx[r];
      if (b < 0 || b >= p.nb) {  // outside the state: the row moves nothing
        for (int c = 0; c < 8; ++c) D[(size_t)c * m + r] = 0.0f;
        continue;
      }
      for (int c = 0; c < 8; ++c) {
        const float g = p.mode == MODE_NO_LANE_SELECT ? S[((b / p.lanes) * p.lanes + c) * 8]
                                                      : S[b * 8 + c];
        const float d = math_block(g);
        if (p.mode == MODE_GATHER_ONLY)
          part = __fadd_rn(part, d);
        else
          D[(size_t)c * m + r] = d;
      }
    }
    if (p.mode == MODE_GATHER_ONLY) {
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_down_sync(0xffffffffu, part, off));
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        float sum = 0.0f;
        for (int w = 0; w < NWARPS; ++w) sum = __fadd_rn(sum, red[w]);
        S[0] = __fadd_rn(S[0], __fmul_rn(sum, 1e-30f));
      }
      continue;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      const int b = sidx[sord[q]];
      if (b < 0 || b >= p.nb || (q > 0 && sidx[sord[q - 1]] == b)) continue;
      float acc[8];
      for (int c = 0; c < 8; ++c) acc[c] = S[b * 8 + c];
      for (int q2 = q; q2 < m && sidx[sord[q2]] == b; ++q2)
        for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], D[(size_t)c * m + sord[q2]]);
      for (int c = 0; c < 8; ++c) S[b * 8 + c] = acc[c];
    }
  }
  __syncthreads();
  if (p.transposed) {
#pragma unroll 8
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int b, c;
      body_comp(p, i, b, c);
      p.vout[i] = S[b * 8 + c];
    }
  } else {
    for (int b = threadIdx.x; b < p.nb; b += blockDim.x) {
      const float4* row = reinterpret_cast<const float4*>(S + (size_t)b * 8);
      const float4 lo = row[0], hi = row[1];
      const float g[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      for (int c = 0; c < 8; ++c) p.vout[chunk_at(p, b, c)] = g[c];
    }
  }
  if (!(GATHER && MATH && SCATTER) && sink == 1e-38f) p.vout[0] = sink;
}

}  // namespace

extern "C" int probe_sweep_launch(const float* vin, float* vout, const int* idx,
                                  const int* order, const int* distinct, int nb, int m,
                                  int passes, int lanes, int transposed, int mode,
                                  void* stream) {
  Params p{vin, vout, idx, order, distinct, nb, m, passes, lanes, transposed, mode};
  // The wrapper's sweep_smem_bytes.
  const size_t smem = smem_words(nb, m) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        probe_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  probe_sweep_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
