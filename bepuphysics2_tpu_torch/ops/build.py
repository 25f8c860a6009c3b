"""Build the port's CUDA kernels into plain-C shared libraries and load them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` file at first use into ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``), keyed by a hash of the source, of every
``csrc/*.cuh`` header and of the flags (a kernel's own flags included), so an edited
source or shared header never loads a stale library. Nothing but the repository's sources goes into the build. ``bind`` loads a
library once and returns its C entry point with its argument types set, cached, so a
wrapper's launch costs a dictionary lookup and the ctypes call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

# Every kernel of the port: its label and its source ``csrc/<name>.cu``.
KERNELS = {"K1": "substeps_contacts", "K2": "substeps_contacts_win", "K3": "contact_sweep",
           "K4": "contact_sweep_win", "K5": "probe_sweep", "K6": "probe_gather",
           "K7": "probe_scatter", "K8": "conservative_advance"}
# Flags of one kernel beside ``NVCC_FLAGS``. K8 holds each operation to the rounding of
# its plain PyTorch version, one op at a time: no multiply-add may be contracted.
KERNEL_FLAGS = {"conservative_advance": ["-fmad=false"]}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded: dict = {}
_bound: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def source_key(name: str, csrc: Path = CSRC, defines=()) -> str:
    """Build key of ``<csrc>/<name>.cu``: a hash of that source, of every header in
    ``csrc`` (name and bytes, in name order), of the compiler flags (the kernel's own in
    ``KERNEL_FLAGS`` too) and of the extra ``defines``, if any."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + KERNEL_FLAGS.get(name, [])).encode())
    if defines:
        h.update(("\0" + " ".join(defines)).encode())
    return h.hexdigest()[:16]


def label(name: str, defines=()) -> str:
    """The key of a library in ``load_all``'s result: ``name``, or ``name[defines]`` for a
    variant built with extra ``-D`` defines."""
    return f"{name}[{' '.join(defines)}]" if defines else name


def load_all(names, variants=()):
    """Build (where needed) and load ``csrc/<name>.cu`` for every name, and for every
    (name, defines) pair of ``variants`` the same source built with ``-D`` each define (a
    variant for measurement, such as K5's ``K5_PARTS``); one ``nvcc`` per library, all
    started together. Returns {label: (ctypes.CDLL, build seconds)} keyed by ``label``;
    the seconds are 0.0 for a library that was already built or loaded."""
    jobs = [(name, ()) for name in names] + [(name, tuple(d)) for name, d in variants]
    procs, out = {}, {}
    for name, defines in jobs:
        lab = label(name, defines)
        if lab in _loaded or lab in procs:
            continue
        key = source_key(name, defines=defines)
        lib_path = BUILD_DIR / f"{name}-{key}.so"
        if lib_path.exists():
            out[lab] = (lib_path, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *KERNEL_FLAGS.get(name, []),
               *(f"-D{d}" for d in defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[lab] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib_path, tmp, name, key, time.perf_counter())
    for lab, (proc, lib_path, tmp, name, key, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        (BUILD_DIR / f"{name}-{key}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lab}:\n{log}")
        os.replace(tmp, lib_path)
        out[lab] = (lib_path, seconds)
    for lab, (lib_path, seconds) in out.items():
        _loaded[lab] = ctypes.CDLL(str(lib_path))
    labels = [label(name, defines) for name, defines in jobs]
    return {lab: (_loaded[lab], out[lab][1] if lab in out else 0.0) for lab in labels}


def load(name: str, defines=()):
    """Build (if needed) and load ``csrc/<name>.cu`` (with ``defines``, a variant).
    Returns (ctypes.CDLL, build seconds; 0.0 when the library was already built or
    loaded)."""
    return load_all([], [(name, defines)])[label(name, defines)]


def bind(name: str, fn_name: str, argtypes, defines=()):
    """The C entry point ``fn_name`` of ``csrc/<name>.cu`` (with ``defines``, a variant),
    built and loaded at the first call, with ``restype`` c_int (the CUDA error code) and
    ``argtypes`` set then. Later calls return the same cached function object."""
    key = (label(name, defines), fn_name)
    fn = _bound.get(key)
    if fn is None:
        lib, _ = load(name, defines) if defines else load(name)
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _bound[key] = fn
    return fn


def raw_stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, as an int, without the
    ``torch.cuda.Stream`` object that ``current_stream`` builds per call."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) of the newest build."""
    logs = sorted(BUILD_DIR.glob(f"{name}-*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""
