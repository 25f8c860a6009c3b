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
// flops per row and a scatter with two barriers, so the critical path is 36 passes of a
// few microseconds of shared-memory latency and barriers. The card's own bounds are far
// below: the bytes (state in and out, the indices: 0.41 MB at NB 4,096, M 1,024, 36
// passes) take ~0.12 us at 3.35 TB/s, the ~6.5 MFLOP ~0.1 us at 67 TFLOP/s.
//
// Design: what the TPU prototypes kept in VMEM stays in shared memory. ONE block of 1,024
// threads loads the whole state, (NB, 8) f32 (128 KB at 4,096 bodies), from the caller's
// layout once, walks the passes in order and writes the state back in the same layout at
// the end; device memory sees only the indices in between. Per pass, every thread
// computes its rows' deltas from the state before the pass into shared memory;
// __syncthreads(); then the first entry of each body's run in the pass's stable sort (the
// wrapper's) adds the whole run in ascending row order, so repeated indices sum
// deterministically without float atomics; __syncthreads(). The arithmetic uses
// __fmul_rn/__fadd_rn/__fsub_rn so that nvcc contracts nothing into an FMA: a pass
// without repeated indices gives the plain version's bits. Mode C's sum is a fixed-order
// block reduction (warp shuffles, then the warps in order). It uses one SM of 132, as
// the TPU probe used one core: its time per pass is the floor of a one-block walk.
//
// Layouts (f32, row-major), for NB bodies and a chunk width L (`lanes`):
//   chunk-major (v1, v2; L = 128)  (NB/L, 8L), component c of body b at
//                                  (b/L)*8L + c*L + b%L
//   transposed (v3 L = 128, v4 L = 8)  (8L, NB/L), at (c*L + b%L)*(NB/L) + b/L
//   idx, order (passes, M) int32: each pass's body list and its stable sort

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MODE_SWEEP = 0, MODE_GATHER_ONLY = 1, MODE_NO_LANE_SELECT = 2;

struct Params {
  const float* vin; float* vout; const int* idx; const int* order;
  int nb, m, passes, lanes, transposed, mode;
};

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

__global__ void __launch_bounds__(NTHREADS) probe_sweep_kernel(Params p) {
  extern __shared__ float smem[];
  float* S = smem;                              // (nb, 8) body state
  float* D = S + (size_t)p.nb * 8;              // (m, 8) deltas of the pass
  int* sidx = reinterpret_cast<int*>(D + (size_t)p.m * 8);  // (m,) the pass's bodies
  int* sord = sidx + p.m;                       // (m,) their stable sort
  float* red = reinterpret_cast<float*>(sord + p.m);        // (NWARPS,) mode C sums
  const int n = p.nb * 8;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int b, c;
    body_comp(p, i, b, c);
    S[b * 8 + c] = p.vin[i];
  }
  __syncthreads();
  for (int pass = 0; pass < p.passes; ++pass) {
    const int* idx = p.idx + (size_t)pass * p.m;
    const int* ord = p.order + (size_t)pass * p.m;
    float part = 0.0f;
    for (int r = threadIdx.x; r < p.m; r += blockDim.x) {
      const int b = idx[r];
      sidx[r] = b;
      sord[r] = ord[r];
      float* d = D + (size_t)r * 8;
      if (b < 0 || b >= p.nb) {  // outside the state: the row moves nothing
        for (int c = 0; c < 8; ++c) d[c] = 0.0f;
        continue;
      }
      for (int c = 0; c < 8; ++c) {
        const float g = p.mode == MODE_NO_LANE_SELECT ? S[((b / p.lanes) * p.lanes + c) * 8]
                                                      : S[b * 8 + c];
        d[c] = math_block(g);
        part = __fadd_rn(part, d[c]);
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
      __syncthreads();
      continue;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < p.m; q += blockDim.x) {
      const int b = sidx[sord[q]];
      if (b < 0 || b >= p.nb || (q > 0 && sidx[sord[q - 1]] == b)) continue;
      float acc[8];
      for (int c = 0; c < 8; ++c) acc[c] = S[b * 8 + c];
      for (int q2 = q; q2 < p.m && sidx[sord[q2]] == b; ++q2) {
        const float* d = D + (size_t)sord[q2] * 8;
        for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], d[c]);
      }
      for (int c = 0; c < 8; ++c) S[b * 8 + c] = acc[c];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int b, c;
    body_comp(p, i, b, c);
    p.vout[i] = S[b * 8 + c];
  }
}

}  // namespace

extern "C" int probe_sweep_launch(const float* vin, float* vout, const int* idx,
                                  const int* order, int nb, int m, int passes, int lanes,
                                  int transposed, int mode, void* stream) {
  Params p{vin, vout, idx, order, nb, m, passes, lanes, transposed, mode};
  // The wrapper's sweep_smem_bytes: state, deltas, body list and sort, warp sums.
  const size_t smem = (size_t)nb * 32 + (size_t)m * 32 + (size_t)m * 8 + NWARPS * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        probe_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  probe_sweep_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
