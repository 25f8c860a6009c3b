"""The port's host-side native code: the quickhull convex hull builder and the solid
inertia of a hull (``hull.cpp``; reference Collidables/ConvexHullHelper.cs:87 ComputeHull,
MeshInertiaHelper.cs).

The host compiler (``g++``) builds ``hull.cpp`` at first use into ``build/native/`` at
the root of the checkout (listed in ``.gitignore``), keyed by a hash of the source and the
flags, and ctypes loads it. Where no compiler is present ``load`` returns None and every
entry point returns None, so that the callers (``shapes.registry.ConvexHull``) take their
scipy path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hull.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False

_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int)


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"hull-{h.hexdigest()[:16]}.so"


def load():
    """The loaded library, built on first use; None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        try:
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                               capture_output=True, timeout=300)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.bepu_quickhull.restype = ctypes.c_int
        lib.bepu_quickhull.argtypes = [_dp, ctypes.c_int, _ip, _ip, _ip, _ip, _dp, _dp]
        lib.bepu_hull_inertia.restype = ctypes.c_int
        lib.bepu_hull_inertia.argtypes = [_dp, ctypes.c_int, _ip, ctypes.c_int, ctypes.c_double,
                                          _dp, _dp]
        _lib = lib
        return _lib


def quickhull(points):
    """(vertex ids, triangles, centroid, volume) of the convex hull of ``points`` (n, 3):
    the triangles index the input points, wound outward. None where the library is
    missing or the input is degenerate."""
    lib = load()
    pts = np.ascontiguousarray(points, np.float64)
    n = pts.shape[0]
    if lib is None or n < 4:
        return None
    vert_ids = np.empty(n, np.int32)
    tris = np.empty((2 * n, 3), np.int32)
    nverts, ntris, volume = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_double(0)
    centroid = np.empty(3, np.float64)
    rc = lib.bepu_quickhull(pts.ctypes.data_as(_dp), n, vert_ids.ctypes.data_as(_ip),
                            ctypes.byref(nverts), tris.ctypes.data_as(_ip), ctypes.byref(ntris),
                            centroid.ctypes.data_as(_dp), ctypes.byref(volume))
    if rc != 0:
        return None
    return vert_ids[:nverts.value].copy(), tris[:ntris.value].copy(), centroid, float(volume.value)


def hull_inertia(points, triangles, mass: float):
    """(inverse inertia as xx yx yy zx zy zz, inverse mass) of the uniform solid bounded
    by ``triangles`` (wound outward, indexing ``points``), about the origin; None on
    failure."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float64)
    tris = np.ascontiguousarray(triangles, np.int32)
    inv_inertia = np.empty(6, np.float64)
    inv_mass = ctypes.c_double(0)
    rc = lib.bepu_hull_inertia(pts.ctypes.data_as(_dp), pts.shape[0], tris.ctypes.data_as(_ip),
                               tris.shape[0], ctypes.c_double(mass),
                               inv_inertia.ctypes.data_as(_dp), ctypes.byref(inv_mass))
    if rc != 0:
        return None
    return tuple(inv_inertia.tolist()), float(inv_mass.value)
