// K2: the whole substepped contact solve over the windowed body layout, in one cooperative
// launch over the card, for NVIDIA Hopper (sm_90a).
//
// Replaces bepuphysics2_tpu/ops/sweep.py::_win_substeps_kernel
// (solve_substeps_contacts_win), the solve of scenes above 8,192 bodies: per substep,
// the incremental depth update of every live slice (substeps after the first), the pose /
// velocity / world-inertia block on every layout position, the warm start of every live
// slice, then the velocity iterations over the live slices, slices in ascending order in
// every phase, with the per-row math of contact_rows.cuh (shared with K1, K3 and K4).
//
// What bounds it: the chain of dependent slice passes, not flops or bandwidth (its work
// is ~0.02 ms at the card's rates). The TPU grid (n_substeps, 2 + n_iters, n_slices)
// walks every live slice in order; one block doing the same on one SM of 132 spent ~9.7
// us per slice pass (PERF.md). The waves below cut the chain to the number of waves; on
// the 16,384-body bank of chip_smoke.py phase 7 the slices that stay in order (85 of 545
// per pass) take most of a launch, at ~7.5 us per slice pass on one block
// (tools/k2_vs_parent.py, H100).
//
// Design: one persistent grid of every block the card can hold at once (occupancy x SMs),
// launched with cudaLaunchCooperativeKernel, phases separated by grid barriers
// (cooperative_groups::this_grid().sync()); each block's plan, the staging, the sums and
// the grid's size are waves.cuh's, shared with K1 and K4, and the row is contact_rows.cuh
// body_row, shared with K1. The depth update and the body block are grid-stride loops.
// The slice walk goes in WAVES (solver/solve.py wave_table): a wave
// is a maximal run of consecutive live slices of one color c < C in the narrow region,
// and the blocks take its slices round-robin (slice k of the wave to block k mod
// gridDim.x), one grid barrier after the wave. Every other live slice (the narrow Jacobi
// color C and the wide region, which share bodies across slices) is a wave of one; a
// run of such waves is walked in order by block 0 alone, block barriers only, and the
// other blocks wait at the grid barrier after it. Slices are never reordered.
//
// Why a wave is exact: the pair store's per-body color claims make each color c < C an
// independent set over dynamic bodies, across all Morton blocks, so the slices of one
// wave touch pairwise distinct dynamic bodies. Non-dynamic bodies are read, never
// written (zero inverse mass and inertia take no delta). So every body a wave's slice
// reads is the value the in-order walk would read, each body is written by one slice,
// and its deltas are summed in the same order: the same floating-point computation as
// the walk, bit for bit, with no float atomics. chip_smoke.py checks the disjointness on
// the 16,384-body pile.
//
// Each slice: its rows read the state from before the slice (wide slices mix colors and
// share bodies, every wide row is mass-split), write their deltas to shared memory, and
// each position's run in the wrapper's stable sort of the slice's positions is summed in
// a fixed order. A row side names its body window-relatively, rel = whi2 * 8 + wlo2; its
// layout position is wseg[slice][rel >> 10] * 8 + (rel & 1023). While a block solves one
// slice, cp.async copies the state-independent inputs of its next slice (the 32 prestep
// rows, whi2, wlo2, scales, the sort, the window) into a second shared-memory stage, so
// only the body-row gather (velocities and inertia, which also seed the sums; each row
// read as four 16-byte loads), the row math and the sums stay on the chain. Dead slices
// (wseg[slice][0] < 0) are not in the table. Padding rows in a live slice are zero with
// scale 1 and add zero. Non-dynamic bodies sit twice in the layout (appendix and spatial
// position); both copies integrate alike, and the caller reads the spatial one.
//
// Memory visibility: bg, pose, imp and the depth rows are written by one SM and read by
// another after a grid barrier, so no pointer is __restrict__ and none is read through
// __ldg; the grid barrier orders the writes before the reads (release / acquire).
// SASS (cuobjdump -sass, CUDA 12.8; tools/k2_vs_parent.py --sass): the only
// LDG.E.CONSTANT loads read the math library's sinf/cosf argument-reduction table
// (__cudart_i2opi_f, ld.global.nc in the PTX); no state array takes that path.
//
// Layouts (row-major, f32 unless noted):
//   bg, pose, aux  (np, 16) / (np, 8) / (np, 8) as in K1, over layout positions
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract)
//   imp   (16, B)   rows 0-7 accumulated impulses, rows 8-11 contact depths (initial
//                   depths on entry), rows 12-15 unused; all updated in place
//   whi2, wlo2 (int32), scale, order (int32)  (n_slices * 2 * sb,) per slice: sb A sides
//                   then sb B sides; order is the slice's stable sort of its positions
//   wseg  (n_slices, 4) int32 window segment start columns; [.][0] < 0 = dead slice
//   waves (2 * n_slices + 2,) int32: [0] the wave count W, [1 .. n_slices + 1] each
//                   wave's first index into the live list, [n_slices + 2 ..] the live
//                   slices in ascending order
// ps_t, whi2, wlo2, scale, order and wseg must be 16-byte aligned, sb a multiple of 4.

#include "contact_rows.cuh"
#include "waves.cuh"

namespace {

constexpr int NTHREADS = 512;
constexpr int WSEG = 4;    // window segments per slice
constexpr int BLK = 1024;  // bodies per window segment

struct WinParams {
  float* bg; float* pose; const float* aux; const float* ps; float* imp;
  const int* whi2; const int* wlo2; const float* scale; const int* wseg; const int* order;
  const int* waves;
  int np, B, sb, n_slices, n_substeps, n_iters;
  StepConsts c;
};

// Shared memory, in 4-byte words, for slices of sb rows (2 sb row sides) and a table of
// n slices: two stages of [prestep 32 sb | whi2 | wlo2 | scale | order (2 sb each) |
// window 4], then the deltas D and velocities V (2 sb x 6 each), the positions and the
// write flags (2 sb each), and this block's plan (waves.cuh).
__host__ __device__ constexpr size_t stage_words(int sb) { return (size_t)40 * sb + 4; }
__host__ __device__ constexpr size_t smem_words(int sb, int n) {
  return 2 * stage_words(sb) + (size_t)28 * sb + plan_words(n);
}

struct Smem {
  float* stage[2];
  float* D; float* V; int* pos; int* wr;
  Plan plan;
};

__device__ Smem carve(float* smem, int sb, int n) {
  Smem m;
  m.stage[0] = smem;
  m.stage[1] = smem + stage_words(sb);
  m.D = m.stage[1] + stage_words(sb);
  m.V = m.D + (size_t)12 * sb;
  m.pos = reinterpret_cast<int*>(m.V + (size_t)12 * sb);
  m.wr = m.pos + 2 * sb;
  m.plan = carve_plan(m.wr + 2 * sb, n);
  return m;
}

__device__ __forceinline__ bool slice_live(const WinParams& p, int sl) {
  return p.wseg[(size_t)sl * WSEG] >= 0;
}

// Layout position of entry e (an A or B side) of slice sl, from global memory.
__device__ __forceinline__ int win_pos(const WinParams& p, int sl, size_t e) {
  const int rel = p.whi2[e] * 8 + p.wlo2[e];
  return max(p.wseg[(size_t)sl * WSEG + (rel >> 10)], 0) * 8 + (rel & (BLK - 1));
}

// Copy slice sl's state-independent inputs into a stage, 16 bytes per copy.
__device__ void stage_slice(const WinParams& p, float* st, int sl) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  stage_rows(st, p.ps + (size_t)sl * sb, p.B, PS_ROWS, sb);
  float* ent = st + (size_t)PS_ROWS * sb;
  stage_arrays(ent, 4, 2 * sb, e0, p.whi2, p.wlo2, p.scale, p.order);
  if (threadIdx.x == 0)
    __pipeline_memcpy_async(ent + (size_t)8 * sb, p.wseg + (size_t)sl * WSEG, 16);
  __pipeline_commit();
}

// One live slice of warm start (solve = false) or of one velocity iteration, its inputs
// staged in st: rows (contact_rows.cuh body_row, the prestep read from the stage), then
// each position's run summed in the slice's stable sort, seeded with the velocities the
// rows read (waves.cuh sum_runs: an entry writes where its body has inertia).
__device__ void run_slice(const WinParams& p, const Smem& m, const float* st, int sl,
                          bool solve) {
  const int sb = p.sb;
  const int* hi = reinterpret_cast<const int*>(st + (size_t)PS_ROWS * sb);
  const int* lo = hi + 2 * sb;
  const float* sc = reinterpret_cast<const float*>(lo + 2 * sb);
  const int* ord = reinterpret_cast<const int*>(sc + 2 * sb);
  const int* seg = ord + 2 * sb;
  const float* dep = p.imp + (size_t)IMP_ROWS * p.B;
  for (int r = threadIdx.x; r < sb; r += blockDim.x) {
    int ab[2];
    for (int side = 0; side < 2; ++side) {
      const int e = side * sb + r;
      const int rel = hi[e] * 8 + lo[e];
      ab[side] = max(seg[rel >> 10], 0) * 8 + (rel & (BLK - 1));
      m.pos[e] = ab[side];
    }
    bool still_a, still_b;
    body_row(p.bg, st, sb, r, p.imp, dep, p.B, sl * sb + r, ab[0], ab[1], sc[r], sc[sb + r],
             solve, p.c.inv_h, m.D + (size_t)r * 6, m.D + (size_t)(sb + r) * 6,
             m.V + (size_t)r * 6, m.V + (size_t)(sb + r) * 6, &still_a, &still_b);
    m.wr[r] = !still_a;
    m.wr[sb + r] = !still_b;
  }
  __syncthreads();
  sum_runs(p.bg, 16, m.pos, ord, m.D, m.V, m.wr, 2 * sb);
}

__global__ void __launch_bounds__(NTHREADS, 1) substeps_contacts_win_kernel(WinParams p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem m = carve(smem, p.sb, p.n_slices);
  plan(p.waves, p.n_slices, m.plan, false);
  const int nseg = m.plan.counts[0], njobs = m.plan.counts[1];
  const int* jobs = m.plan.jobs;
  const int sb = p.sb;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x, gstride = gridDim.x * blockDim.x;
  float* dep = p.imp + (size_t)IMP_ROWS * p.B;
  int buf = 0;
  if (njobs > 0) stage_slice(p, m.stage[0], jobs[0]);
  for (int s = 0; s < p.n_substeps; ++s) {
    // Phase 0: incremental depth update for substeps after the first; it reads the
    // velocities only, so every live slice's rows run at once.
    if (s > 0) {
      for (int col = gtid; col < p.B; col += gstride) {
        const int sl = col / sb, r = col - sl * sb;
        if (!slice_live(p, sl)) continue;
        const size_t e0 = (size_t)sl * 2 * sb;
        depth_row(p.ps, p.B, col, dep, p.bg, win_pos(p, sl, e0 + r),
                  win_pos(p, sl, e0 + sb + r), p.c.h);
      }
      grid.sync();
    }
    // Phase 1: the body block on every layout position.
    for (int b = gtid; b < p.np; b += gstride)
      pose_vel_inertia_body(p.bg + (size_t)b * 16, p.pose + (size_t)b * 8, p.aux + (size_t)b * 8,
                            s, p.c);
    grid.sync();
    // The warm start, then the velocity iterations: the same waves in every pass.
    for (int pass = 0; pass <= p.n_iters; ++pass) {
      int j = 0;
      for (int g = 0; g < nseg; ++g) {
        for (int t = 0; t < m.plan.segn[g]; ++t, ++j) {
          __pipeline_wait_prior(0);
          __syncthreads();  // this stage landed; the previous slice is done with the other
          stage_slice(p, m.stage[buf ^ 1], jobs[j + 1 < njobs ? j + 1 : 0]);
          run_slice(p, m, m.stage[buf], jobs[j], pass > 0);
          buf ^= 1;
        }
        grid.sync();
      }
    }
  }
  __pipeline_wait_prior(0);
}

GridCache grid_cache;

}  // namespace

// The number of blocks K2 launches for n_slices slices of sb rows, or minus the CUDA
// error that keeps it from being co-scheduled.
extern "C" int substeps_contacts_win_grid(int sb, int n_slices) {
  int blocks = 0;
  const cudaError_t err = grid_for(substeps_contacts_win_kernel, NTHREADS,
                                   smem_words(sb, n_slices) * 4, grid_cache, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int substeps_contacts_win_launch(
    float* bg, float* pose, const float* aux, const float* ps_t, float* imp,
    const int* whi2, const int* wlo2, const float* scale, const int* wseg, const int* order,
    const int* waves, int np, int B, int sb, int n_substeps, int n_iters, int angular_mode,
    float gx, float gy, float gz, float h, float inv_h, float lin_scale, float ang_scale,
    void* stream) {
  if (sb <= 0 || sb % 4 || B % sb) return (int)cudaErrorInvalidValue;
  WinParams p{bg, pose, aux, ps_t, imp, whi2, wlo2, scale, wseg, order, waves,
              np, B, sb, B / sb, n_substeps, n_iters,
              {angular_mode, gx, gy, gz, h, inv_h, lin_scale, ang_scale}};
  const size_t smem = smem_words(sb, B / sb) * 4;
  int blocks = 0;
  cudaError_t err = grid_for(substeps_contacts_win_kernel, NTHREADS, smem, grid_cache,
                             &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)substeps_contacts_win_kernel, dim3(blocks),
                                    dim3(NTHREADS), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
