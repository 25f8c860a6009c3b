// K7: o = v; o[idx] += d with the last writer winning, for NVIDIA Hopper (sm_90a).
//
// Replaces the scatter probe k5 of experiments/pallas_gather_probe.py (o_ref[:] = v_ref[:];
// o_ref[i_ref[:]] += d_ref[:]). That kernel reads o[idx], adds d and then sets o[idx], so
// where several rows name one target the last row's write is the one that stays: target
// b ends as v[b] + d[j] for the largest j with idx[j] == b. K7 computes exactly that.
//
// What bounds it: bytes. It copies v (128 KB at NB 4,096, W 8) and reads the indices and
// each target's last d row, a few hundred KB in all (~0.1 us at 3.35 TB/s), below one
// launch's latency; its W adds per target are nothing. So a call is one launch: no sort
// ahead of it, no second pass, no grid barrier.
//
// Design: a grid of blocks over row ranges. Block k owns rows [k·ROWS, (k+1)·ROWS) of the
// output, and every output row is written by that one block, so blocks never meet.
//   1. Each block keeps one int winner per owned row in shared memory, -1 at first.
//   2. Its threads read the whole index list, neighbouring threads neighbouring indices
//      (each index is read once per block, so it is read straight from global memory:
//      staging it in shared memory first would add a copy and a barrier and save no
//      load). For every row j whose target lies in the block's range, atomicMax(winner,
//      j). An integer max is the same in any order, so the result is deterministic, as
//      the reference requires: no float atomics anywhere.
//   3. After one __syncthreads() each owned row is written once, a 16-byte vector per
//      thread where W is a multiple of 4 and the arrays are 16-byte aligned (one element
//      per thread otherwise): winner >= 0 ? v + d[winner] : v. That is a select, not an
//      add of zero, so an untouched row keeps v's bits (-0.0 included).
// An index outside [0, NB) lies in no block's range and writes nothing.
//
// Layouts (row-major): v (nb, w) f32, idx (m,) int32, d (m, w) f32, out (nb, w) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int ROWS = 64;  // output rows per block: 64 blocks at NB 4,096

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS) probe_scatter_kernel(const float* v, const int* idx,
                                                                 const float* d, float* out,
                                                                 int nb, int m, int w) {
  __shared__ int win[ROWS];
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, nb - r0);
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) win[r] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += NTHREADS) {
    const int b = idx[j] - r0;
    if (b >= 0 && b < rows) atomicMax(&win[b], j);
  }
  __syncthreads();
  if (VEC) {
    const int w4 = w / 4;
    const float4* v4 = reinterpret_cast<const float4*>(v) + (size_t)r0 * w4;
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* o4 = reinterpret_cast<float4*>(out) + (size_t)r0 * w4;
    for (int i = threadIdx.x; i < rows * w4; i += NTHREADS) {
      const int r = i / w4, c = i - r * w4;
      float4 x = v4[i];
      const int j = win[r];
      if (j >= 0) {
        const float4 y = d4[(size_t)j * w4 + c];
        x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      }
      o4[i] = x;
    }
  } else {
    const float* vr = v + (size_t)r0 * w;
    float* orow = out + (size_t)r0 * w;
    for (int i = threadIdx.x; i < rows * w; i += NTHREADS) {
      const int r = i / w, c = i - r * w;
      const int j = win[r];
      orow[i] = j >= 0 ? vr[i] + d[(size_t)j * w + c] : vr[i];
    }
  }
}

// The same grid and block with no work: the launch floor a call of K7 stands on.
__global__ void __launch_bounds__(NTHREADS) probe_scatter_empty(const float*, const int*,
                                                                const float*, float*, int, int,
                                                                int) {}

inline int blocks_for(int nb) { return (nb + ROWS - 1) / ROWS; }

}  // namespace

extern "C" int probe_scatter_launch(const float* v, const int* idx, const float* d, float* out,
                                    int nb, int m, int w, void* stream) {
  if (nb <= 0 || w <= 0) return 0;
  const bool vec = w % 4 == 0 && ((uintptr_t)v | (uintptr_t)d | (uintptr_t)out) % 16 == 0;
  const dim3 grid(blocks_for(nb)), block(NTHREADS);
  if (vec)
    probe_scatter_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(v, idx, d, out, nb, m,
                                                                         w);
  else
    probe_scatter_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(v, idx, d, out, nb, m,
                                                                          w);
  return (int)cudaGetLastError();
}

// K7's grid launched with an empty kernel through the same arguments: what one launch of
// this shape costs (tools/k2_vs_parent.py --kernel k7 times it beside K7).
extern "C" int probe_scatter_empty_launch(const float* v, const int* idx, const float* d,
                                          float* out, int nb, int m, int w, void* stream) {
  if (nb <= 0) return 0;
  probe_scatter_empty<<<blocks_for(nb), NTHREADS, 0, (cudaStream_t)stream>>>(v, idx, d, out, nb,
                                                                              m, w);
  return (int)cudaGetLastError();
}
