// K3: one contact bank's velocity iterations within one substep of the general solve, in
// one cooperative launch over the card, for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_contact_sweep_kernel (contact_sweep): n_iters
// Gauss-Seidel sweeps over every live slice of one bank, each row gathering both sides'
// velocity and mass-split-scaled inverse mass and inertia, running the per-row contact
// solve with the prestep's depths, writing its impulses back and summing its velocity
// deltas (divided by the side's scale) per body. No integration, no warm start, no
// depth update: the caller does those between launches.
//
// What bounds it: the chain of dependent slice passes, not bytes or flops (its work is
// ~0.0005 ms at the card's rates). One block of 512 threads walking every live slice in
// order spent ~7 us per slice pass on one SM of 132 (PERF.md), 0.44 ms per launch on the
// tube's compound bank.
//
// Design: K1's iteration pass (waves.cuh PAGES_PASS), without K1's depth update, body
// block and warm start. One persistent grid of every block the card can hold at once
// (occupancy x SMs), launched with cudaLaunchCooperativeKernel. Per pass, each wave of the
// table (solver/solve.py page_wave_table: a maximal run of consecutive live pages of one
// color c < C) has its pages dealt to the blocks, one each round-robin, as K4 deals its
// slices (dealing the wave's rows over the grid, as K1 does, was 8% slower on phase 11's
// bank: PERF.md), one grid barrier after the wave; Jacobi pages and one-page waves run in
// order on block 0. A block stages its next page's state-independent inputs with cp.async
// while it solves this one (pages of up to 512 rows; larger ones are read from the bank).
// A bank is the pair store's pages in execution order (pages by color, Jacobi pages last)
// or a compound bucket (C colors of cap rows, whole pages each, then the Jacobi rows).
//
// Writes: an entry (a row side) writes when its row is valid and its body's inertia row
// is not all zero, so statics, the kinematic tube, rows of dead store slots and padding
// rows (which alias a bank's last row) move nothing; the one-block walk this replaces
// added their exact zeros instead, which differs only where a velocity is -0.0. Why a
// wave is exact: the store's color claims and the buckets' coloring make a color's valid
// rows touch pairwise distinct dynamic bodies, so within a wave each written body has one
// writing entry and no other valid row reads it: every row reads the value the in-order
// walk would read and every sum is the walk's, bit for bit, with no float atomics.
// chip_smoke.py checks this on the tube's tables.
//
// Memory visibility: bg and imp are written by one SM and read by another after a grid
// barrier, so no state pointer is __restrict__ or read through __ldg.
//
// Layouts (row-major, f32 unless noted):
//   bg    (nb, 16)  [vx vy vz wx wy wz 0 0 | im, world inverse inertia xx yx yy zx zy zz, 0]
//                   velocities updated in place; the inertia half is read-only
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract); depths at rows 18-21
//   imp   (8, B)    accumulated impulses, updated in place
//   idx2, scale, order  (n_slices * 2 * sb,)  per slice: sb A sides then sb B sides;
//                   order (int32) is the slice's stable sort of its body list with the
//                   writing entries first (ops/sweep.py writer_order)
//   waves (2 * n_slices + 2,) int32 wave table (waves.cuh) over the live slices
// ps_t, idx2, scale and order must be 16-byte aligned, sb a multiple of 4.

#include "contact_rows.cuh"
#include "waves.cuh"

namespace {

constexpr int NTHREADS = 512;
// A color wave's rows dealt over the grid (true) or its slices dealt to the blocks (false):
// PERF.md has both times on the tube's compound-bank shapes (tools/k2_vs_parent.py
// --other-deal builds the other).
constexpr bool DEAL_ROWS = false;

struct Params {
  float* bg; const float* ps; float* imp; const float* dep;
  const int* idx2; const float* scale; const int* order; const int* waves;
  int B, sb, n_slices, n_iters, staged;
  float ih;  // 1 / h
  __device__ float inv_h() const { return ih; }
};

__global__ void __launch_bounds__(NTHREADS, 1) contact_sweep_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const pages::Smem m = pages::carve(smem, p.sb, p.n_slices, p.staged);
  plan(p.waves, p.n_slices, m.plan, DEAL_ROWS);
  const pages::Walk w = pages::walk_of(m.plan, p.sb);
  int buf = 0;
  if (p.staged && w.njobs > 0) pages::stage_slice(p, m.stage[0], m.plan.jobs[0]);
  for (int it = 0; it < p.n_iters; ++it) PAGES_PASS(DEAL_ROWS, p, m, w, grid, true, buf);
  __pipeline_wait_prior(0);
}

GridCache grid_cache;

}  // namespace

// The number of blocks K3 launches for n_slices slices of sb rows, or minus the CUDA
// error that keeps it from being co-scheduled.
extern "C" int contact_sweep_grid(int sb, int n_slices) {
  bool staged = false;
  cudaError_t err = pages::staged_fits(sb, n_slices, &staged);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = grid_for(contact_sweep_kernel, NTHREADS, pages::smem_words(sb, n_slices, staged) * 4,
                 grid_cache, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int contact_sweep_launch(float* bg, const float* ps_t, float* imp, const int* idx2,
                                    const float* scale, const int* order, const int* waves,
                                    int B, int sb, int n_iters, float inv_h, void* stream) {
  if (sb <= 0 || sb % 4 || B % sb) return (int)cudaErrorInvalidValue;
  bool staged = false;
  cudaError_t err = pages::staged_fits(sb, B / sb, &staged);
  if (err != cudaSuccess) return (int)err;
  Params p{bg, ps_t, imp, ps_t + (size_t)PS_DEPTH * B, idx2, scale, order, waves,
           B, sb, B / sb, n_iters, staged, inv_h};
  const size_t smem = pages::smem_words(sb, B / sb, staged) * 4;
  int blocks = 0;
  err = grid_for(contact_sweep_kernel, NTHREADS, smem, grid_cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)contact_sweep_kernel, dim3(blocks),
                                    dim3(NTHREADS), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
