// K6: a row gather, out = v[idx], for NVIDIA Hopper (sm_90a).
//
// Replaces the gather probes of experiments/pallas_gather_probe.py: k1 (v_ref[i_ref[:]]),
// k2 (jnp.take along axis 0), k3 (take_along_axis along axis 0), k4 (a scalar loop over
// rows with the indices in SMEM) and k6 (a one-hot f32 matmul). Each asked how a TPU
// kernel can read rows by index from VMEM; all five compute the same (M, W) rows.
//
// What bounds it: bytes. It does no arithmetic; the least it must move is the distinct
// rows it reads, the indices and the output (~33 KB at M 512, W 8: ~0.01 us at 3.35
// TB/s), far below one launch's latency. A call is set by the launch and by the host
// work of its wrapper (ops/probes.py binds the entry point once and checks cheaply).
//
// Design: the card reads rows by index directly, so no routing is carried over. Where W
// is a multiple of 4 and both arrays are 16-byte aligned, one thread copies one 16-byte
// vector (an (NB, 8) row is two float4): neighbouring threads read the neighbouring
// vectors of a row and write neighbouring outputs. Any other width takes one thread per
// element. An index outside [0, NB) gives a NaN row.
//
// Layouts (row-major): v (nb, w) f32, idx (m,) int32, out (m, w) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS) probe_gather_vec4(const float4* v, const int* idx,
                                                              float4* out, int nb, int m,
                                                              int w4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * w4) return;
  const int j = i / w4, c = i - j * w4;
  const int b = idx[j];
  const float nan = __int_as_float(0x7fc00000);
  out[i] = (b >= 0 && b < nb) ? v[(size_t)b * w4 + c] : make_float4(nan, nan, nan, nan);
}

__global__ void __launch_bounds__(NTHREADS) probe_gather_scalar(const float* v, const int* idx,
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
  if (m * w == 0) return 0;
  const bool vec = w % 4 == 0 && ((uintptr_t)v | (uintptr_t)out) % 16 == 0;
  if (vec) {
    const int n = m * (w / 4);
    probe_gather_vec4<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(v), idx, reinterpret_cast<float4*>(out), nb, m, w / 4);
  } else {
    const int n = m * w;
    probe_gather_scalar<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0, (cudaStream_t)stream>>>(
        v, idx, out, nb, m, w);
  }
  return (int)cudaGetLastError();
}

// The same seven arguments and nothing else: the cost of a ctypes call into this library,
// the floor under the wrapper's per-call time (chip_smoke.py phase 22 times it).
extern "C" int probe_gather_noop(const float*, const int*, float*, int, int, int, void*) {
  return 0;
}
