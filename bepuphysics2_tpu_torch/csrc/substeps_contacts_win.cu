// K2: the whole substepped contact solve over the windowed body layout, in one launch,
// for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_win_substeps_kernel
// (solve_substeps_contacts_win), the solve of scenes above 8,192 bodies: per substep,
// the incremental depth update of every live slice (substeps after the first), the pose /
// velocity / world-inertia block on every layout position, the warm start of every live
// slice, then the velocity iterations over the live slices, slices in ascending order in
// every phase, with the per-row math of contact_rows.cuh (shared with K1).
//
// What bounds it: as K1, the latency of a chain of dependent slice passes, about
// (1 + iterations) x live slices x substeps of them, on one SM; not flops or bandwidth.
//
// Design: K1's. One block of 512 threads walks (substep, phase, slice) itself,
// __syncthreads() between slices. The TPU kernel's routing (bf16x3 one-hot matmuls over
// a transposed (comp * 8, NCH) state) is gone: body state is packed rows read by index.
// Each row side names its body window-relatively, rel = whi2 * 8 + wlo2; its layout
// position is wseg[slice][rel >> 10] * 8 + (rel & 1023), resolved here from the same
// arguments the JAX function takes. A slice's positions go to shared memory; its rows
// all read the state from before the slice (wide slices mix colors and share bodies,
// every wide row is mass-split), write their deltas to shared memory, and each
// position's run in the wrapper's stable sort of the positions is summed in a fixed
// order: deterministic, no float atomics. Dead slices (wseg[slice][0] < 0) are skipped.
// Padding rows in a live slice are zero with scale 1 and add zero. Non-dynamic bodies sit
// twice in the layout (appendix and spatial position); both copies have zero inverse mass
// and inertia, take no delta and integrate alike, and the caller reads the spatial one.
//
// Layouts (row-major, f32 unless noted):
//   bg, pose, aux  (np, 16) / (np, 8) / (np, 8) as in K1, over layout positions
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract)
//   imp   (16, B)   rows 0-7 accumulated impulses, rows 8-11 contact depths (initial
//                   depths on entry), rows 12-15 unused; all updated in place
//   whi2, wlo2 (int32), scale, order (int32)  (n_slices * 2 * sb,) per slice: sb A sides
//                   then sb B sides; order is the slice's stable sort of its positions
//   wseg  (n_slices, 4) int32 window segment start columns; [.][0] < 0 = dead slice

#include "contact_rows.cuh"

namespace {

constexpr int NTHREADS = 512;
constexpr int WSEG = 4;  // window segments per slice
constexpr int BLK = 1024;  // bodies per window segment

struct WinParams {
  float* bg; float* pose; const float* aux; const float* ps; float* imp;
  const int* whi2; const int* wlo2; const float* scale; const int* wseg; const int* order;
  int np, B, sb, n_slices, n_substeps, n_iters;
  StepConsts c;
};

__device__ __forceinline__ bool slice_live(const WinParams& p, int sl) {
  return p.wseg[(size_t)sl * WSEG] >= 0;
}

// Layout position of entry e (an A or B side) of slice sl.
__device__ __forceinline__ int win_pos(const WinParams& p, int sl, size_t e) {
  const int rel = p.whi2[e] * 8 + p.wlo2[e];
  return max(p.wseg[(size_t)sl * WSEG + (rel >> 10)], 0) * 8 + (rel & (BLK - 1));
}

// One live slice of warm start (solve = false) or of one velocity iteration.
__device__ void run_slice(const WinParams& p, int sl, bool solve, float* D, int* pos) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  for (int q = threadIdx.x; q < 2 * sb; q += blockDim.x) pos[q] = win_pos(p, sl, e0 + q);
  __syncthreads();
  const float* dep = p.imp + (size_t)IMP_ROWS * p.B;
  for (int r = threadIdx.x; r < sb; r += blockDim.x)
    slice_row(p.ps, p.B, sl * sb + r, p.imp, dep, p.bg, pos[r], pos[sb + r], p.scale[e0 + r],
              p.scale[e0 + sb + r], solve, p.c.inv_h, D + (size_t)r * 6,
              D + (size_t)(sb + r) * 6);
  __syncthreads();
  sum_deltas(p.bg, pos, p.order + e0, D, 2 * sb);
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS) substeps_contacts_win_kernel(WinParams p) {
  extern __shared__ float smem[];
  const int sb = p.sb;
  float* D = smem;
  int* pos = reinterpret_cast<int*>(smem + (size_t)2 * sb * 6);
  float* dep = p.imp + (size_t)IMP_ROWS * p.B;
  for (int s = 0; s < p.n_substeps; ++s) {
    // Phase 0: incremental depth update for substeps after the first; it reads the
    // velocities only, so every live slice's rows run at once.
    if (s > 0) {
      for (int col = threadIdx.x; col < p.B; col += blockDim.x) {
        const int sl = col / sb, r = col - sl * sb;
        if (!slice_live(p, sl)) continue;
        const size_t e0 = (size_t)sl * 2 * sb;
        depth_row(p.ps, p.B, col, dep, p.bg, win_pos(p, sl, e0 + r),
                  win_pos(p, sl, e0 + sb + r), p.c.h);
      }
      __syncthreads();
    }
    // Phase 1: the body block on every layout position, then the warm start.
    for (int b = threadIdx.x; b < p.np; b += blockDim.x)
      pose_vel_inertia_body(p.bg + (size_t)b * 16, p.pose + (size_t)b * 8, p.aux + (size_t)b * 8,
                            s, p.c);
    __syncthreads();
    for (int sl = 0; sl < p.n_slices; ++sl)
      if (slice_live(p, sl)) run_slice(p, sl, false, D, pos);
    // Phases 2+: velocity iterations.
    for (int it = 0; it < p.n_iters; ++it)
      for (int sl = 0; sl < p.n_slices; ++sl)
        if (slice_live(p, sl)) run_slice(p, sl, true, D, pos);
  }
}

}  // namespace

extern "C" int substeps_contacts_win_launch(
    float* bg, float* pose, const float* aux, const float* ps_t, float* imp,
    const int* whi2, const int* wlo2, const float* scale, const int* wseg, const int* order,
    int np, int B, int sb, int n_substeps, int n_iters, int angular_mode,
    float gx, float gy, float gz, float h, float inv_h, float lin_scale, float ang_scale,
    void* stream) {
  WinParams p{bg, pose, aux, ps_t, imp, whi2, wlo2, scale, wseg, order,
              np, B, sb, B / sb, n_substeps, n_iters,
              {angular_mode, gx, gy, gz, h, inv_h, lin_scale, ang_scale}};
  const size_t smem = (size_t)2 * sb * (6 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        substeps_contacts_win_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  substeps_contacts_win_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
