"""Build the port's CUDA kernels into plain-C shared libraries and load them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` file at first use into ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``), keyed by a hash of the source and the flags,
so a rebuilt or edited source never loads a stale library. Nothing but the repository's
sources goes into the build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def load(name: str):
    """Build (if needed) and load ``csrc/<name>.cu``. Returns (ctypes.CDLL, build seconds;
    0.0 when the library was already built or loaded)."""
    if name in _loaded:
        return _loaded[name], 0.0
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{key}.so"
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (BUILD_DIR / f"{name}-{key}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib, seconds


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) of the newest build."""
    logs = sorted(BUILD_DIR.glob(f"{name}-*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""
