// K1: the whole substepped contact solve in one cooperative launch over the card, for
// NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_substeps_kernel (solve_substeps_contacts):
// per substep, the incremental depth update (substeps after the first), the pose /
// velocity / world-inertia block, a warm start of every slice, then the velocity
// iterations over every slice, in the same phase order, slice order and per-row math.
//
// What bounds it: the chain of dependent slice passes, not flops or bandwidth (its work
// is ~0.003 ms at the card's rates). One block of 512 threads walking every slice in
// order spent ~15 us per slice pass on one SM of 132 (PERF.md), 7.7 ms per launch on the
// 4,096-body pile's bank.
//
// Design: K2's (substeps_contacts_win.cu) over the page-execution order, with the wave
// walk of waves.cuh (its iteration pass, PAGES_PASS, shared with K3). One persistent grid
// of every block the card can hold at once (occupancy x SMs), launched with
// cudaLaunchCooperativeKernel, phases separated by grid barriers. The depth update and the
// body block are grid-stride loops. The warm start and every iteration pass go by the
// waves of the table (solver/solve.py waves_by_key: a maximal run of consecutive live
// pages of one color c < C of one bank): a wave's rows are dealt over every thread of the
// grid, a row per thread, its writing sides stored straight, one grid barrier after the
// wave (the same bits as its pages dealt to the blocks, and faster on the 4,096-body pile:
// PERF.md). Jacobi pages stay in order on block 0, one slice pass per page. While block 0
// solves one, cp.async copies the next one's prestep rows, scales, body indices and sort
// into a second shared-memory stage (38 words a row: the 4 depth rows of the prestep,
// which the row math does not read, are copied too, to keep one copy loop), where the two
// stages fit in a block's shared memory (pages of up to 512 rows: ~210 KB of the H100's
// 227 KB); larger pages are read from the bank (SimConfig.store_page 1,024 and 2,048).
// Body rows are read as four 16-byte loads (contact_rows.cuh body_row, shared with K2).
//
// Writes: an entry (a row side) writes when its row is valid and its body's inertia is
// not all zero, so statics and rows of dead slots (which keep their retired bodies) and
// padding rows (which alias a bank's last row) move nothing: the one-block walk this
// replaces added their exact zeros instead, which differs only where a velocity is -0.0.
// Why a wave is exact: the pair store's color claims (and the compound banks' coloring)
// make a color's valid rows touch pairwise distinct dynamic bodies, so within a wave each
// written body has one writing entry and no other valid row reads it: every row reads the
// value the in-order walk would read and every sum is the walk's, bit for bit, with no
// float atomics. chip_smoke.py checks this on the 4,096-body pile's and the compound
// pile's tables.
//
// Memory visibility: bg, pose, imp and dep are written by one SM and read by another
// after a grid barrier, so no state pointer is __restrict__ or read through __ldg.
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
//                   order (int32) is the slice's stable sort of its body list with the
//                   writing entries first (ops/sweep.py writer_order)
//   slive (n_slices,) int32: slice holds at least one valid row
//   waves (2 * n_slices + 2,) int32 wave table (waves.cuh) over the live slices
// ps_t, idx2, scale and order must be 16-byte aligned, sb a multiple of 4.

#include "contact_rows.cuh"
#include "waves.cuh"

namespace {

constexpr int NTHREADS = 512;

struct Params {
  float* bg; float* pose; const float* aux; const float* ps; float* imp; float* dep;
  const int* idx2; const float* scale; const int* order; const int* slive; const int* waves;
  int nb, B, sb, n_slices, n_substeps, n_iters, staged;
  StepConsts c;
  __device__ float inv_h() const { return c.inv_h; }
};

__global__ void __launch_bounds__(NTHREADS, 1) substeps_contacts_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const pages::Smem m = pages::carve(smem, p.sb, p.n_slices, p.staged);
  plan(p.waves, p.n_slices, m.plan, true);
  const pages::Walk w = pages::walk_of(m.plan, p.sb);
  const int sb = w.sb, gtid = w.gtid, gstride = w.gstride;
  int buf = 0;
  if (p.staged && w.njobs > 0) pages::stage_slice(p, m.stage[0], m.plan.jobs[0]);
  for (int s = 0; s < p.n_substeps; ++s) {
    // Phase 0: incremental depth update for substeps after the first. It reads the
    // velocities only, so every live slice's rows run at once.
    if (s > 0) {
      for (int col = gtid; col < p.B; col += gstride) {
        const int sl = col / sb, r = col - sl * sb;
        if (!p.slive[sl]) continue;
        const size_t e0 = (size_t)sl * 2 * sb;
        depth_row(p.ps, p.B, col, p.dep, p.bg, p.idx2[e0 + r], p.idx2[e0 + sb + r], p.c.h);
      }
      grid.sync();
    }
    // Phase 1: the body block, and (first substep) the depth scratch from the prestep.
    for (int b = gtid; b < p.nb; b += gstride)
      pose_vel_inertia_body(p.bg + (size_t)b * 16, p.pose + (size_t)b * 8, p.aux + (size_t)b * 8,
                            s, p.c);
    if (s == 0) {
      for (int col = gtid; col < p.B; col += gstride)
        for (int k = 0; k < 4; ++k)
          p.dep[(size_t)k * p.B + col] = p.ps[(size_t)(PS_DEPTH + k) * p.B + col];
    }
    grid.sync();
    // The warm start, then the velocity iterations: the same waves in every pass.
    for (int pass = 0; pass <= p.n_iters; ++pass)
      PAGES_PASS(true, p, m, w, grid, pass > 0, buf);
  }
  __pipeline_wait_prior(0);
}

GridCache grid_cache;

}  // namespace

// The number of blocks K1 launches for n_slices slices of sb rows, or minus the CUDA
// error that keeps it from being co-scheduled.
extern "C" int substeps_contacts_grid(int sb, int n_slices) {
  bool staged = false;
  cudaError_t err = pages::staged_fits(sb, n_slices, &staged);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = grid_for(substeps_contacts_kernel, NTHREADS, pages::smem_words(sb, n_slices, staged) * 4,
                 grid_cache, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int substeps_contacts_launch(
    float* bg, float* pose, const float* aux, const float* ps_t, float* imp, float* dep,
    const int* idx2, const float* scale, const int* order, const int* slive, const int* waves,
    int nb, int B, int sb, int n_substeps, int n_iters, int angular_mode,
    float gx, float gy, float gz, float h, float inv_h, float lin_scale, float ang_scale,
    void* stream) {
  if (sb <= 0 || sb % 4 || B % sb) return (int)cudaErrorInvalidValue;
  bool staged = false;
  cudaError_t err = pages::staged_fits(sb, B / sb, &staged);
  if (err != cudaSuccess) return (int)err;
  Params p{bg, pose, aux, ps_t, imp, dep, idx2, scale, order, slive, waves,
           nb, B, sb, B / sb, n_substeps, n_iters, staged,
           {angular_mode, gx, gy, gz, h, inv_h, lin_scale, ang_scale}};
  const size_t smem = pages::smem_words(sb, B / sb, staged) * 4;
  int blocks = 0;
  err = grid_for(substeps_contacts_kernel, NTHREADS, smem, grid_cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)substeps_contacts_kernel, dim3(blocks),
                                    dim3(NTHREADS), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
