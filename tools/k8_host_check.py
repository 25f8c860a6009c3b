"""K8's CUDA source checked on the host, without a card or nvcc.

``bepuphysics2_tpu_torch/csrc/conservative_advance.cu`` is compiled with ``g++ -x c++``
against a stub ``cuda_runtime.h`` (the CUDA qualifiers empty; ``threadIdx``, ``blockIdx``
and ``blockDim`` thread-local; the warp intrinsics as one lane alone, which is what a lane
sees when no other lane asks; ``atomicAdd`` and ``cudaMemsetAsync`` on host memory) into
a shared library under ``build/k8_host/``. Its ``K8_LAUNCH`` runs every thread of a
launch's grid one after the other: pass 1 over every record, then pass 2, whose first
thread walks the whole queue while the others find it drained. The result is held bit
for bit to the plain version (``sweeps.conservative_advance_plain``) on the records of
``tests/test_torch_k8.py``, both forms, with ``sinf``, ``cosf`` and ``sqrt`` taken in
float64 and rounded on both sides: the host's and the CPU build of PyTorch's own
functions differ from each other by an ulp, where on the card K8 and PyTorch's CUDA ops
call the same ones.

    python3 tools/k8_host_check.py

Prints, per form and miss rule, the records bit for bit equal, the share pass 1
finished, and the advancement and GJK iterations run; exits 1 on a difference.
"""
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "bepuphysics2_tpu_torch" / "csrc" / "conservative_advance.cu"
OUT = ROOT / "build" / "k8_host"

STUB = r"""
#pragma once
#include <math.h>
#include <string.h>
#include <stddef.h>
#include <algorithm>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(n)
struct k8_dim3 { unsigned x, y, z; };
static thread_local k8_dim3 threadIdx, blockIdx, blockDim;
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
enum { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = 1;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
// One lane alone: the ballot is its own bit.
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u << (threadIdx.x & 31) : 0u; }
inline bool __any_sync(unsigned, bool p) { return p; }
inline int __shfl_sync(unsigned, int v, int) { return v; }
inline int __popc(unsigned m) { return __builtin_popcount(m); }
inline int __ffs(unsigned m) { return __builtin_ffs((int)m); }
inline int atomicAdd(int* p, int v) { const int old = *p; *p += v; return old; }
using std::max;
using std::min;
// float64 rounded, as the plain side takes them here.
inline float k8_sinf(float x) { return (float)sin((double)x); }
inline float k8_cosf(float x) { return (float)cos((double)x); }
inline float k8_sqrtf(float x) { return (float)sqrt((double)x); }
#define sinf k8_sinf
#define cosf k8_cosf
#define sqrtf k8_sqrtf
#define K8_LAUNCH(kernel, blocks, args, stream)                           \
  do {                                                                   \
    blockDim.x = NTHREADS;                                               \
    for (unsigned b_ = 0; b_ < (unsigned)(blocks); ++b_)                 \
      for (unsigned t_ = 0; t_ < (unsigned)NTHREADS; ++t_) {             \
        blockIdx.x = b_;                                                 \
        threadIdx.x = t_;                                                \
        kernel(args);                                                    \
      }                                                                  \
  } while (0)
"""


def build_host():
    """The host library of K8's source (built where it is not yet, keyed by the source's
    and the stub's hash). Raises RuntimeError without ``g++``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    key = hashlib.sha256(SOURCE.read_bytes() + STUB.encode()).hexdigest()[:16]
    lib = OUT / f"conservative_advance-{key}.so"
    if not lib.exists():
        stub = OUT / "stub" / key
        stub.mkdir(parents=True, exist_ok=True)
        (stub / "cuda_runtime.h").write_text(STUB)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
               "-I", str(stub), "-o", str(tmp), str(SOURCE)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"g++ failed:\n{done.stderr}")
        os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).conservative_advance_launch
    fn.restype = ctypes.c_int
    from bepuphysics2_tpu_torch.collision import sweeps

    fn.argtypes = sweeps._K8_ARGS
    return fn


def run_host(fn, rec, iters, miss_max_t, work=None):
    """K8's host build on CPU records (``sweeps.Records``): (out, queued), ``queued`` the
    records pass 1 left to pass 2."""
    n = rec.n
    out = torch.empty(n, dtype=torch.float32)
    queue = torch.empty(n, 2, dtype=torch.int32)
    counters = torch.empty(2, dtype=torch.int32)
    ptr = lambda t: None if t is None else t.data_ptr()
    hx, hy, hz = (c.contiguous() for c in rec.hull_points)
    exists = None if rec.exists is None else rec.exists.contiguous()
    err = fn(rec.a.f.data_ptr(), rec.a.i.data_ptr(), rec.a.rows, rec.b.f.data_ptr(),
             rec.b.i.data_ptr(), rec.b.rows, ptr(rec.pairs), ptr(exists), n,
             rec.hull_rows.data_ptr(), rec.hull_rows.shape[1], hx.data_ptr(), hy.data_ptr(),
             hz.data_ptr(), rec.max_t, iters, int(miss_max_t), out.data_ptr(), ptr(work),
             queue.data_ptr(), counters.data_ptr(), 3, None)
    if err:
        raise RuntimeError(f"the host build returned {err}")
    return out, int(counters[0])


@contextlib.contextmanager
def float64_rounded():
    """``torch.sin``, ``cos`` and ``sqrt`` taken in float64 and rounded to float32."""
    real = {k: getattr(torch, k) for k in ("sin", "cos", "sqrt")}
    try:
        for k, f in real.items():
            setattr(torch, k, lambda x, f=f: f(x.double()).to(x.dtype))
        yield
    finally:
        for k, f in real.items():
            setattr(torch, k, f)


def main():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_k8 as t8
    from bepuphysics2_tpu_torch.collision import sweeps

    torch.set_num_threads(1)
    fn = build_host()
    reg, rows = t8.build_registry(t8.treg)
    shapes = reg.device("cpu")
    bad = 0
    for form in ("product", "explicit"):
        rec = t8.draw_tables(shapes, rows, form)
        for iters, miss in ((sweeps.SWEEP_ITERS, False), (12, True)):
            work = torch.zeros(rec.n, 2, dtype=torch.int32)
            got, queued = run_host(fn, rec, iters, miss, work)
            with float64_rounded():
                want = sweeps.conservative_advance_plain(rec, iters, miss)
            equal = (got == want) | (torch.isnan(got) & torch.isnan(want))
            bad += int((~equal).sum())
            w = work.sum(0).tolist()
            print(f"{form}, {iters} iterations, miss {'max_t' if miss else '3e38'}: "
                  f"{int(equal.sum())} of {rec.n} records bit for bit equal; pass 1 "
                  f"finished {1 - queued / rec.n:.3f}; {w[0]} advancement and {w[1]} GJK "
                  f"iterations; hits {int((want < (rec.max_t if miss else 1e30)).sum())}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
