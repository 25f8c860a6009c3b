// K7: o = v; o[idx] += d with the last writer winning, for NVIDIA Hopper (sm_90a).
//
// Replaces the scatter probe k5 of experiments/pallas_gather_probe.py (o_ref[:] = v_ref[:];
// o_ref[i_ref[:]] += d_ref[:]). That kernel reads o[idx], adds d and then sets o[idx], so
// where several rows name one target the last row's write is the one that stays: target
// b ends as v[b] + d[j] for the largest j with idx[j] == b. K7 computes exactly that.
//
// What bounds it: bytes. It copies v (128 KB at NB 4,096, W 8) and writes the targeted
// rows, a few hundred KB in all (~0.1 us at 3.35 TB/s), below one launch's latency; its
// W adds per target are nothing.
//
// Design: ONE block of 1,024 threads, so that one __syncthreads() orders the copy before
// the writes: first the block copies v to the output; then entry q of the wrapper's
// stable sort of idx writes its row only when entry q + 1 names another target, i.e.
// only the last row of each run (the largest j, since the sort keeps equal indices in
// row order). Every target is written once: the result is the same on every run, with
// no atomics. An index outside [0, NB) writes nothing.
//
// Layouts (row-major): v (nb, w) f32, idx and order (m,) int32, d (m, w) f32,
// out (nb, w) f32.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 1024;

__global__ void __launch_bounds__(NTHREADS) probe_scatter_kernel(const float* v, const int* idx,
                                                                 const int* order,
                                                                 const float* d, float* out,
                                                                 int nb, int m, int w) {
  const int n = nb * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = v[i];
  __syncthreads();
  for (int q = threadIdx.x; q < m; q += blockDim.x) {
    const int j = order[q], b = idx[j];
    if (b < 0 || b >= nb || (q + 1 < m && idx[order[q + 1]] == b)) continue;
    for (int c = 0; c < w; ++c)
      out[(size_t)b * w + c] = v[(size_t)b * w + c] + d[(size_t)j * w + c];
  }
}

}  // namespace

extern "C" int probe_scatter_launch(const float* v, const int* idx, const int* order,
                                    const float* d, float* out, int nb, int m, int w,
                                    void* stream) {
  probe_scatter_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(v, idx, order, d, out, nb, m,
                                                                 w);
  return (int)cudaGetLastError();
}
