// K1: the whole substepped contact solve in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_substeps_kernel (solve_substeps_contacts):
// per substep, the incremental depth update (substeps after the first), the pose /
// velocity / world-inertia block, a warm start of every slice, then the velocity
// iterations over every slice, in the same phase order, slice order and per-row math.
//
// What bounds it: latency and L2 traffic, not flops. Each slice is a gather of two body
// rows per constraint row, ~400 flops of per-row algebra, and a scatter of velocity
// deltas; slices must run one after another (Gauss-Seidel over color pages), so the
// critical path is the chain of ~(2 + iterations) x slices x substeps dependent steps.
//
// Design: ONE thread block of 512 threads walks the grid's (substep, phase, slice) order
// itself; __syncthreads() separates slices. Body state lives in device memory (about
// 0.5 MB at 4k bodies, L2-resident). Each slice first computes every row's deltas into
// shared memory, then sums them per body in a fixed order (the wrapper's stable sort of
// the slice's body list), so the result is deterministic by construction: no float
// atomics, and rows of a Jacobi page all read the state from before the slice. This
// uses one SM of 132; spreading the solve over the card is later work. One launch per
// step.
//
// Layouts (row-major, f32 unless noted):
//   bg    (nb, 16)  [vx vy vz wx wy wz 0 0 | im, world inverse inertia xx yx yy zx zy zz, 0]
//   pose  (nb, 8)   [px py pz qx qy qz qw 0]
//   aux   (nb, 8)   [im, local inverse inertia xx yx yy zx zy zz, mask code]
//                   mask code = gravity-mask + 2 * integrate-mask
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract)
//   imp   (8, B)    accumulated impulses, updated in place
//   dep   (4, B)    depth scratch
//   idx2, scale, order  (n_slices * 2 * sb,)  per slice: sb A sides then sb B sides;
//                   order (int32) is the slice's stable sort of its body list
//   slive (n_slices,) int32: slice holds at least one valid row

#include "contact_rows.cuh"

namespace {

constexpr int NTHREADS = 512;

struct Params {
  float* bg; float* pose; const float* aux; const float* ps; float* imp; float* dep;
  const int* idx2; const float* scale; const int* order; const int* slive;
  int nb, B, sb, n_slices, n_substeps, n_iters;
  StepConsts c;
};

// One slice of warm start (solve = false) or of one velocity iteration (solve = true):
// every row's deltas go to shared memory, then each body's deltas are summed onto its
// velocity in the slice's sorted order.
__device__ void run_slice(const Params& p, int sl, bool solve, float* D) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  for (int r = threadIdx.x; r < sb; r += blockDim.x)
    slice_row(p.ps, p.B, sl * sb + r, p.imp, p.dep, p.bg, p.idx2[e0 + r], p.idx2[e0 + sb + r],
              p.scale[e0 + r], p.scale[e0 + sb + r], solve, p.c.inv_h, D + (size_t)r * 6,
              D + (size_t)(sb + r) * 6);
  __syncthreads();
  sum_deltas(p.bg, p.idx2 + e0, p.order + e0, D, 2 * sb);
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS) substeps_contacts_kernel(Params p) {
  extern __shared__ float D[];
  const int sb = p.sb;
  for (int s = 0; s < p.n_substeps; ++s) {
    // Phase 0: incremental depth update for substeps after the first. It reads the
    // velocities only, so every slice's rows run at once.
    if (s > 0) {
      for (int col = threadIdx.x; col < p.B; col += blockDim.x) {
        const int sl = col / sb, r = col - sl * sb;
        if (!p.slive[sl]) continue;
        const size_t e0 = (size_t)sl * 2 * sb;
        depth_row(p.ps, p.B, col, p.dep, p.bg, p.idx2[e0 + r], p.idx2[e0 + sb + r], p.c.h);
      }
      __syncthreads();
    }
    // Phase 1: the body block, then (first substep) the depth scratch from the prestep,
    // then the warm start of every slice.
    for (int b = threadIdx.x; b < p.nb; b += blockDim.x)
      pose_vel_inertia_body(p.bg + (size_t)b * 16, p.pose + (size_t)b * 8, p.aux + (size_t)b * 8,
                            s, p.c);
    if (s == 0) {
      for (int col = threadIdx.x; col < p.B; col += blockDim.x)
        for (int k = 0; k < 4; ++k)
          p.dep[(size_t)k * p.B + col] = p.ps[(size_t)(PS_DEPTH + k) * p.B + col];
    }
    __syncthreads();
    for (int sl = 0; sl < p.n_slices; ++sl)
      if (p.slive[sl]) run_slice(p, sl, false, D);
    // Phases 2+: velocity iterations.
    for (int it = 0; it < p.n_iters; ++it)
      for (int sl = 0; sl < p.n_slices; ++sl)
        if (p.slive[sl]) run_slice(p, sl, true, D);
  }
}

}  // namespace

extern "C" int substeps_contacts_launch(
    float* bg, float* pose, const float* aux, const float* ps_t, float* imp, float* dep,
    const int* idx2, const float* scale, const int* order, const int* slive,
    int nb, int B, int sb, int n_substeps, int n_iters, int angular_mode,
    float gx, float gy, float gz, float h, float inv_h, float lin_scale, float ang_scale,
    void* stream) {
  Params p{bg, pose, aux, ps_t, imp, dep, idx2, scale, order, slive,
           nb, B, sb, B / sb, n_substeps, n_iters,
           {angular_mode, gx, gy, gz, h, inv_h, lin_scale, ang_scale}};
  const size_t smem = (size_t)2 * sb * 6 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        substeps_contacts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  substeps_contacts_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
