// K6: a row gather, out = v[idx], for NVIDIA Hopper (sm_90a).
//
// Replaces the gather probes of experiments/pallas_gather_probe.py: k1 (v_ref[i_ref[:]]),
// k2 (jnp.take along axis 0), k3 (take_along_axis along axis 0), k4 (a scalar loop over
// rows with the indices in SMEM) and k6 (a one-hot f32 matmul). Each asked how a TPU
// kernel can read rows by index from VMEM; all five compute the same (M, W) rows.
//
// What bounds it: bytes. It does no arithmetic; the least it must move is the distinct
// rows it reads, the indices and the output (~33 KB at M 512, W 8: ~0.01 us at 3.35
// TB/s), far below one launch's latency.
//
// Design: the card reads rows by index directly, so no routing is carried over. One
// thread per output element over a grid of M x W: neighbouring threads read neighbouring
// components of a row and write neighbouring outputs. An index outside [0, NB) gives a
// NaN row.
//
// Layouts (row-major): v (nb, w) f32, idx (m,) int32, out (m, w) f32.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS) probe_gather_kernel(const float* v, const int* idx,
                                                                float* out, int nb, int m,
                                                                int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * w) return;
  const int j = i / w, c = i - j * w;
  const int b = idx[j];
  out[i] = (b >= 0 && b < nb) ? v[(size_t)b * w + c] : __int_as_float(0x7fc00000);
}

}  // namespace

extern "C" int probe_gather_launch(const float* v, const int* idx, float* out, int nb, int m,
                                   int w, void* stream) {
  const int n = m * w;
  if (n == 0) return 0;
  probe_gather_kernel<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0, (cudaStream_t)stream>>>(
      v, idx, out, nb, m, w);
  return (int)cudaGetLastError();
}
