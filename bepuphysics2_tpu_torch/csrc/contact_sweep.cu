// K3: one contact bank's velocity iterations within one substep of the general solve,
// for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_contact_sweep_kernel (contact_sweep): n_iters
// Gauss-Seidel sweeps over every slice of one bank, each row gathering both sides'
// velocity and mass-split-scaled inverse mass and inertia, running the per-row contact
// solve with the prestep's depths, writing its impulses back and summing its velocity
// deltas (divided by the side's scale) per body. No integration, no warm start, no
// depth update: the caller does those between launches.
//
// What bounds it: latency, not bytes or flops. A slice is a gather of two body rows per
// constraint row, ~400 flops of per-row algebra and a scatter of deltas, and slices run
// one after another (Gauss-Seidel over colors), so the critical path is iterations x
// slices dependent steps of a few microseconds each.
//
// Design: K1's one-block walk. ONE block of 512 threads walks (iteration, slice) in
// order, __syncthreads() between slices; live slices only (a slice without a valid row
// moves no body). Each slice writes every row's deltas to shared memory, then the first
// entry of each body's run in the slice's stable sort (the wrapper's) adds the whole run
// in ascending order: deterministic, no float atomics. The per-row math, the body-row
// loads and the fixed-order sum are K1's, from contact_rows.cuh. The TPU kernel's bf16x3
// one-hot routing and transposed (comp * 8, NCH) state are gone: body rows are read by
// index. One launch per bank, per iteration round, per substep.
//
// Layouts (row-major, f32 unless noted):
//   bg    (nb, 16)  [vx vy vz wx wy wz 0 0 | im, world inverse inertia xx yx yy zx zy zz, 0]
//                   velocities updated in place; the inertia half is read-only
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract); depths at rows 18-21
//   imp   (8, B)    accumulated impulses, updated in place
//   idx2, scale, order  (n_slices * 2 * sb,)  per slice: sb A sides then sb B sides;
//                   order (int32) is the slice's stable sort of its body list
//   slive (n_slices,) int32: slice holds at least one valid row

#include "contact_rows.cuh"

namespace {

constexpr int NTHREADS = 512;

struct Params {
  float* bg; const float* ps; float* imp; const int* idx2; const float* scale;
  const int* order; const int* slive;
  int B, sb, n_slices, n_iters;
  float inv_h;
};

__global__ void __launch_bounds__(NTHREADS) contact_sweep_kernel(Params p) {
  extern __shared__ float D[];
  const int sb = p.sb;
  const float* dep = p.ps + (size_t)PS_DEPTH * p.B;
  for (int it = 0; it < p.n_iters; ++it) {
    for (int sl = 0; sl < p.n_slices; ++sl) {
      if (!p.slive[sl]) continue;
      const size_t e0 = (size_t)sl * 2 * sb;
      for (int r = threadIdx.x; r < sb; r += blockDim.x)
        slice_row(p.ps, p.B, sl * sb + r, p.imp, dep, p.bg, p.idx2[e0 + r],
                  p.idx2[e0 + sb + r], p.scale[e0 + r], p.scale[e0 + sb + r], true, p.inv_h,
                  D + (size_t)r * 6, D + (size_t)(sb + r) * 6);
      __syncthreads();
      sum_deltas(p.bg, p.idx2 + e0, p.order + e0, D, 2 * sb);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int contact_sweep_launch(float* bg, const float* ps_t, float* imp, const int* idx2,
                                    const float* scale, const int* order, const int* slive,
                                    int B, int sb, int n_iters, float inv_h,
                                    void* stream) {
  Params p{bg, ps_t, imp, idx2, scale, order, slive, B, sb, B / sb, n_iters, inv_h};
  const size_t smem = (size_t)2 * sb * 6 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        contact_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  contact_sweep_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
