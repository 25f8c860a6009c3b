// K4: one windowed contact bank's velocity iterations within one substep of the general
// solve above 8,192 bodies, for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_contact_sweep_win_kernel (contact_sweep_win):
// n_iters Gauss-Seidel sweeps over every live slice of the pair store's bank in the
// windowed Morton layout of solver/windowing.py. Each row reads both sides' velocities
// at their layout positions and both sides' inverse mass and world inverse inertia from
// the streamed rows (already multiplied by the mass-split scale: no scaling here), runs
// the per-row contact solve with the prestep's depths, writes its impulses back and sums
// its velocity deltas (divided by the side's scale) per layout position. No integration,
// no warm start, no depth update: the caller does those between launches.
//
// What bounds it: as K3, latency: iterations x live slices dependent slice passes of a
// few microseconds each, on one SM; not bytes or flops.
//
// Design: K3's one-block walk with K2's windows. ONE block of 512 threads walks
// (iteration, slice) in order, __syncthreads() between slices. A slice is dead when
// wseg[slice][0] < 0 and is skipped; every other slice runs, rows without a valid flag
// included (they add zero and keep their impulses), as the JAX kernel runs them. Each row
// side names its body window-relatively, rel = whi2 * 8 + wlo2; its layout position is
// wseg[slice][rel >> 10] * 8 + (rel & 1023), resolved here into shared memory. Positions
// are absolute, so a segment named twice in a slice is harmless. Each position's deltas
// are summed in the wrapper's stable sort of the slice's positions, in ascending entry
// order: deterministic, no float atomics. The TPU kernel's bf16x3 one-hot routing and
// transposed (comp * 8, NCH) state are gone: velocities are rows read by index.
//
// Layouts (row-major, f32 unless noted):
//   bg    (np, 16)  [vx vy vz wx wy wz 0 ... 0] per layout position, updated in place
//   it    (16, B)   streamed inertia: rows 0-6 the A side (im, world inverse inertia xx
//                   yx yy zx zy zz), rows 8-14 the B side; mass-split
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract); depths at rows 18-21
//   imp   (8, B)    accumulated impulses, updated in place
//   whi2, wlo2 (int32), scale, order (int32)  (n_slices * 2 * sb,) per slice: sb A sides
//                   then sb B sides; order is the slice's stable sort of its positions
//   wseg  (n_slices, 4) int32 window segment start columns; [.][0] < 0 = dead slice

#include "contact_rows.cuh"

namespace {

constexpr int NTHREADS = 512;
constexpr int WSEG = 4;  // window segments per slice
constexpr int BLK = 1024;  // bodies per window segment

struct Params {
  float* bg; const float* it; const float* ps; float* imp;
  const int* whi2; const int* wlo2; const float* scale; const int* wseg; const int* order;
  int B, sb, n_slices, n_iters;
  float inv_h;
};

__global__ void __launch_bounds__(NTHREADS) contact_sweep_win_kernel(Params p) {
  extern __shared__ float smem[];
  const int sb = p.sb;
  float* D = smem;
  int* pos = reinterpret_cast<int*>(smem + (size_t)2 * sb * 6);
  const float* dep = p.ps + (size_t)PS_DEPTH * p.B;
  for (int it = 0; it < p.n_iters; ++it) {
    for (int sl = 0; sl < p.n_slices; ++sl) {
      const int* seg = p.wseg + (size_t)sl * WSEG;
      if (seg[0] < 0) continue;
      const size_t e0 = (size_t)sl * 2 * sb;
      for (int q = threadIdx.x; q < 2 * sb; q += blockDim.x) {
        const int rel = p.whi2[e0 + q] * 8 + p.wlo2[e0 + q];
        pos[q] = max(seg[rel >> 10], 0) * 8 + (rel & (BLK - 1));
      }
      __syncthreads();
      for (int r = threadIdx.x; r < sb; r += blockDim.x) {
        const int col = sl * sb + r;
        float ia_im, ib_im;
        S3 ia_ii, ib_ii;
        load_inertia_rows(p.it, p.B, col, 0, ia_im, ia_ii);
        load_inertia_rows(p.it, p.B, col, 1, ib_im, ib_ii);
        row_pass(p.ps, p.B, col, p.imp, dep, p.bg, pos[r], pos[sb + r], ia_im, ia_ii, ib_im,
                 ib_ii, p.scale[e0 + r], p.scale[e0 + sb + r], true, p.inv_h,
                 D + (size_t)r * 6, D + (size_t)(sb + r) * 6);
      }
      __syncthreads();
      sum_deltas(p.bg, pos, p.order + e0, D, 2 * sb, false);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int contact_sweep_win_launch(float* bg, const float* it, const float* ps_t,
                                        float* imp, const int* whi2, const int* wlo2,
                                        const float* scale, const int* wseg, const int* order,
                                        int B, int sb, int n_iters, float inv_h,
                                        void* stream) {
  Params p{bg, it, ps_t, imp, whi2, wlo2, scale, wseg, order, B, sb, B / sb, n_iters, inv_h};
  const size_t smem = (size_t)2 * sb * (6 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        contact_sweep_win_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  contact_sweep_win_kernel<<<1, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
