// K4: one windowed contact bank's velocity iterations within one substep of the general
// solve above 8,192 bodies, in one cooperative launch over the card, for NVIDIA Hopper
// (sm_90a).
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
// What bounds it: the chain of dependent slice passes (its work is ~0.01 ms at the card's
// rates). One block walking every live slice in order spent ~25 us per slice pass on one
// SM of 132 (PERF.md): three block barriers and three dependent global round trips per
// slice, and one thread summing every padding entry of a partial slice (all of them name
// the window's first position).
//
// Design: K2's (substeps_contacts_win.cu) with the wave walk of waves.cuh. One persistent
// grid of every block the card can hold at once (occupancy x SMs), launched with
// cudaLaunchCooperativeKernel. Per pass, each wave of the table (solver/solve.py
// wave_table: a maximal run of consecutive live slices of one color c < C in the narrow
// region) is dealt to the blocks, one slice each round-robin, one grid barrier after it;
// the Jacobi and wide slices stay in order on block 0. (Dealing a wave's rows over every
// thread of the grid instead, as K1 does, was no faster here: PERF.md.) While a block
// solves one slice, cp.async copies its next slice's
// state-independent inputs (the prestep and streamed-inertia rows, whi2, wlo2, scales,
// the sort, the window) into a second shared-memory stage; velocities are read as two
// 16-byte loads per side and written as two wide stores.
//
// Writes: an entry (a row side) writes when its row is valid and its streamed inertia is
// not all zero; a position whose run holds no writing entry keeps its value (the static
// ground, padding rows, which name the window's first position). The walk this replaces
// added those runs' exact zeros (+0.0 or -0.0) instead, which differs only where a
// velocity is -0.0; the tests hold the bits. Why a wave is exact: the pair store's color
// claims make a color's valid rows touch pairwise distinct dynamic bodies, so within a
// wave each written position has one writing entry and no other valid row reads it:
// every row reads the value the in-order walk would read and every sum is the walk's, bit
// for bit, with no float atomics. chip_smoke.py checks this on the ragdoll pile's tables.
//
// Memory visibility: bg and imp are written by one SM and read by another after a grid
// barrier, so no state pointer is __restrict__ or read through __ldg.
//
// Layouts (row-major, f32 unless noted):
//   bg    (np, 8)   [vx vy vz wx wy wz 0 0] per layout position, updated in place
//   it    (16, B)   streamed inertia: rows 0-6 the A side (im, world inverse inertia xx
//                   yx yy zx zy zz), rows 8-14 the B side; mass-split
//   ps_t  (32, B)   packed prestep rows (ops/sweep.py PS_* contract); depths at rows 18-21
//   imp   (8, B)    accumulated impulses, updated in place
//   whi2, wlo2 (int32), scale, order (int32)  (n_slices * 2 * sb,) per slice: sb A sides
//                   then sb B sides; order is the slice's stable sort of its positions
//                   with the writing entries first (ops/sweep.py writer_order)
//   wseg  (n_slices, 4) int32 window segment start columns; [.][0] < 0 = dead slice
//   waves (2 * n_slices + 2,) int32 wave table (waves.cuh)
// it, ps_t, whi2, wlo2, scale, order and wseg must be 16-byte aligned, sb a multiple of 4.

#include "contact_rows.cuh"
#include "waves.cuh"

namespace {

constexpr int NTHREADS = 512;
constexpr int WSEG = 4;    // window segments per slice
constexpr int BLK = 1024;  // bodies per window segment
constexpr int IT_ROWS = 16;
constexpr int VROW = 8;    // floats per velocity row

struct Params {
  float* bg; const float* it; const float* ps; float* imp;
  const int* whi2; const int* wlo2; const float* scale; const int* wseg; const int* order;
  const int* waves;
  int B, sb, n_slices, n_iters;
  float inv_h;
};

// Shared memory, in 4-byte words: two stages of [prestep 32 sb | streamed inertia 16 sb |
// whi2 | wlo2 | scale | order (2 sb each) | window 4], the deltas D and velocities V
// (2 sb x 6 each), the positions and write flags (2 sb each), then the plan.
__host__ __device__ constexpr size_t stage_words(int sb) {
  return (size_t)(PS_ROWS + IT_ROWS + 8) * sb + 4;
}
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

__device__ __forceinline__ int win_pos(const int* seg, int hi, int lo) {
  const int rel = hi * 8 + lo;
  return max(seg[rel >> 10], 0) * 8 + (rel & (BLK - 1));
}

// Copy slice sl's state-independent inputs into a stage, 16 bytes per copy.
__device__ void stage_slice(const Params& p, float* st, int sl) {
  const int sb = p.sb;
  const size_t e0 = (size_t)sl * 2 * sb;
  stage_rows(st, p.ps + (size_t)sl * sb, p.B, PS_ROWS, sb);
  stage_rows(st + (size_t)PS_ROWS * sb, p.it + (size_t)sl * sb, p.B, IT_ROWS, sb);
  float* ent = st + (size_t)(PS_ROWS + IT_ROWS) * sb;
  stage_arrays(ent, 4, 2 * sb, e0, p.whi2, p.wlo2, p.scale, p.order);
  if (threadIdx.x == 0)
    __pipeline_memcpy_async(ent + (size_t)8 * sb, p.wseg + (size_t)sl * WSEG, 16);
  __pipeline_commit();
}

// One row of a sweep (contact_rows.cuh row_pass's arithmetic, in the same order): the
// prestep row k at ps + k * stride + c, the streamed inertia row k at it + k * stride + c
// (a stage), impulses at column col. Writes each side's delta divided by
// its scale to da / db, the velocities read to va6 / vb6, and whether each side writes.
__device__ __forceinline__ void sweep_row(const Params& p, const float* ps, const float* it,
                                          int stride, int c, int col, int ba, int bb, float sa,
                                          float sbs, float* da, float* db, float* va6,
                                          float* vb6, bool* wa, bool* wb) {
  const float4* ga = reinterpret_cast<const float4*>(p.bg + (size_t)ba * VROW);
  const float4* gb = reinterpret_cast<const float4*>(p.bg + (size_t)bb * VROW);
  const float4 a0 = ga[0], a1 = ga[1], b0 = gb[0], b1 = gb[1];
  const F3 va_l = f3(a0.x, a0.y, a0.z), va_a = f3(a0.w, a1.x, a1.y);
  const F3 vb_l = f3(b0.x, b0.y, b0.z), vb_a = f3(b0.w, b1.x, b1.y);
  Row row;
  load_row(ps, stride, c, row);
  float ra[7], rb[7];
  for (int k = 0; k < 7; ++k) {
    ra[k] = it[(size_t)k * stride + c];
    rb[k] = it[(size_t)(8 + k) * stride + c];
  }
  float dep[4], im[IMP_ROWS];
  for (int k = 0; k < 4; ++k) dep[k] = row.ps[PS_DEPTH + k];
  for (int k = 0; k < IMP_ROWS; ++k) im[k] = p.imp[(size_t)k * p.B + col];
  const S3 ia_ii = {ra[1], ra[2], ra[3], ra[4], ra[5], ra[6]};
  const S3 ib_ii = {rb[1], rb[2], rb[3], rb[4], rb[5], rb[6]};
  F3 dva_l, dva_a, dvb_l, dvb_a;
  solve_contact_rows(row, dep, im, ra[0], ia_ii, rb[0], ib_ii, va_l, va_a, vb_l, vb_a, p.inv_h,
                     dva_l, dva_a, dvb_l, dvb_a);
  for (int k = 0; k < IMP_ROWS; ++k) p.imp[(size_t)k * p.B + col] = im[k];
  da[0] = dva_l.x / sa; da[1] = dva_l.y / sa; da[2] = dva_l.z / sa;
  da[3] = dva_a.x / sa; da[4] = dva_a.y / sa; da[5] = dva_a.z / sa;
  db[0] = dvb_l.x / sbs; db[1] = dvb_l.y / sbs; db[2] = dvb_l.z / sbs;
  db[3] = dvb_a.x / sbs; db[4] = dvb_a.y / sbs; db[5] = dvb_a.z / sbs;
  va6[0] = va_l.x; va6[1] = va_l.y; va6[2] = va_l.z;
  va6[3] = va_a.x; va6[4] = va_a.y; va6[5] = va_a.z;
  vb6[0] = vb_l.x; vb6[1] = vb_l.y; vb6[2] = vb_l.z;
  vb6[3] = vb_a.x; vb6[4] = vb_a.y; vb6[5] = vb_a.z;
  bool za = true, zb = true;
  for (int k = 0; k < 7; ++k) {
    za = za && ra[k] == 0.0f;
    zb = zb && rb[k] == 0.0f;
  }
  const bool valid = row.ps[PS_VALID] > 0.5f;
  *wa = valid && !za;
  *wb = valid && !zb;
}

// One live slice, its inputs staged in st: rows, then each position's run summed in the
// slice's writer-first stable sort (waves.cuh sum_runs).
__device__ void run_slice(const Params& p, const Smem& m, const float* st, int sl) {
  const int sb = p.sb;
  const float* it = st + (size_t)PS_ROWS * sb;
  const int* hi = reinterpret_cast<const int*>(it + (size_t)IT_ROWS * sb);
  const int* lo = hi + 2 * sb;
  const float* sc = reinterpret_cast<const float*>(lo + 2 * sb);
  const int* ord = reinterpret_cast<const int*>(sc + 2 * sb);
  const int* seg = ord + 2 * sb;
  for (int r = threadIdx.x; r < sb; r += blockDim.x) {
    const int ba = win_pos(seg, hi[r], lo[r]), bb = win_pos(seg, hi[sb + r], lo[sb + r]);
    m.pos[r] = ba;
    m.pos[sb + r] = bb;
    bool wa, wb;
    sweep_row(p, st, it, sb, r, sl * sb + r, ba, bb, sc[r], sc[sb + r], m.D + (size_t)r * 6,
              m.D + (size_t)(sb + r) * 6, m.V + (size_t)r * 6, m.V + (size_t)(sb + r) * 6, &wa,
              &wb);
    m.wr[r] = wa;
    m.wr[sb + r] = wb;
  }
  __syncthreads();
  sum_runs(p.bg, VROW, m.pos, ord, m.D, m.V, m.wr, 2 * sb);
}

__global__ void __launch_bounds__(NTHREADS, 1) contact_sweep_win_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem m = carve(smem, p.sb, p.n_slices);
  plan(p.waves, p.n_slices, m.plan, false);
  const int nseg = m.plan.counts[0], njobs = m.plan.counts[1];
  const int* jobs = m.plan.jobs;
  int buf = 0;
  if (njobs > 0) stage_slice(p, m.stage[0], jobs[0]);
  for (int it = 0; it < p.n_iters; ++it) {
    int j = 0;
    for (int g = 0; g < nseg; ++g) {
      for (int t = 0; t < m.plan.segn[g]; ++t, ++j) {
        __pipeline_wait_prior(0);
        __syncthreads();  // this stage landed; the previous slice is done with the other
        stage_slice(p, m.stage[buf ^ 1], jobs[j + 1 < njobs ? j + 1 : 0]);
        run_slice(p, m, m.stage[buf], jobs[j]);
        buf ^= 1;
      }
      grid.sync();
    }
  }
  __pipeline_wait_prior(0);
}

GridCache grid_cache;

}  // namespace

// The number of blocks K4 launches for n_slices slices of sb rows, or minus the CUDA
// error that keeps it from being co-scheduled.
extern "C" int contact_sweep_win_grid(int sb, int n_slices) {
  int blocks = 0;
  const cudaError_t err = grid_for(contact_sweep_win_kernel, NTHREADS,
                                   smem_words(sb, n_slices) * 4, grid_cache, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int contact_sweep_win_launch(float* bg, const float* it, const float* ps_t,
                                        float* imp, const int* whi2, const int* wlo2,
                                        const float* scale, const int* wseg, const int* order,
                                        const int* waves, int B, int sb, int n_iters,
                                        float inv_h, void* stream) {
  if (sb <= 0 || sb % 4 || B % sb) return (int)cudaErrorInvalidValue;
  Params p{bg, it, ps_t, imp, whi2, wlo2, scale, wseg, order, waves,
           B, sb, B / sb, n_iters, inv_h};
  const size_t smem = smem_words(sb, B / sb) * 4;
  int blocks = 0;
  cudaError_t err = grid_for(contact_sweep_win_kernel, NTHREADS, smem, grid_cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)contact_sweep_win_kernel, dim3(blocks),
                                    dim3(NTHREADS), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
