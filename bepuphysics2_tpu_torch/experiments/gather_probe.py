"""The gather and scatter probes k1-k6 of ``experiments/pallas_gather_probe.py`` through
kernels K6 (``probe_gather``) and K7 (``probe_scatter``).

The TPU probe asked which forms of reading and writing rows by index a Pallas kernel
supports in VMEM. On the card every form is a read by index, so the five gathers (k1-k4,
k6) all run K6, and the scatter k5 runs K7, which keeps the TPU kernel's result: with a
repeated index the last row's write stays.

    python3 -m bepuphysics2_tpu_torch.experiments.gather_probe [--device cpu]

prints ``OK <name>: <first 4 values>`` per probe, as the JAX script does, with the
probe's time beside ``torch.index_select``'s on the same rows. The inputs are the probe's
own: v = arange(NB·8) as (NB, 8), 512 indices from numpy's ``default_rng(0)``, d = 1.
"""
import argparse

import numpy as np
import torch

from ..ops import probes
from . import time_ms

NB, M = 4096, 512


def inputs(device="cpu"):
    """(v (NB, 8) float32, idx (M,) int32, d (M, 8) float32) as the probe makes them."""
    v6 = torch.arange(NB * 8, dtype=torch.float32).reshape(NB, 8)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, NB, M).astype(np.int32))
    d = torch.ones((M, 8), dtype=torch.float32)
    return v6.to(device), idx.to(device), d.to(device)


def scatter_cases(device="cpu"):
    """K7's inputs beside the probe's own: [(label, v, idx, d)], made from numpy's
    ``default_rng(3)``: the probe's indices with distinct ``d`` rows (where the last
    writer shows), all rows naming one target, indices outside [0, NB), more rows than
    targets (M > NB), rows of -0.0 (an untouched row keeps its sign), and rows of 6 floats
    (not a multiple of 4: one element per thread)."""
    rng = np.random.default_rng(3)
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    i32 = lambda lo, hi, n: torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))
    v, idx, _ = inputs()
    cases = [("distinct d", v, idx, f32(M, 8)),
             ("one target", v, torch.full((M,), 77, dtype=torch.int32), f32(M, 8)),
             ("out of range", v, i32(-600, NB + 600, M), f32(M, 8)),
             ("M > NB", f32(100, 8), i32(0, 100, 1000), f32(1000, 8)),
             ("-0.0 rows", torch.full((300, 8), -0.0), i32(0, 300, 64), torch.zeros(64, 8)),
             ("W 6", f32(200, 6), i32(0, 200, 150), f32(150, 6))]
    return [(label, *(t.to(device) for t in ts)) for label, *ts in cases]


def k1(v, idx):
    """``o_ref[:] = v_ref[i_ref[:]]``."""
    return probes.probe_gather(v, idx)


def k2(v, idx):
    """``jnp.take(v, idx, axis=0)``."""
    return probes.probe_gather(v, idx)


def k3(v, idx):
    """``jnp.take_along_axis(v, idx broadcast to (M, 8), axis=0)``."""
    return probes.probe_gather(v, idx)


def k4(v, idx):
    """A scalar loop over the rows, indices in SMEM."""
    return probes.probe_gather(v, idx)


def k5(v, idx, d):
    """``o = v; o[idx] += d``, read-add-then-set: the last writer wins."""
    return probes.probe_scatter(v, idx, d)


def k6(v, idx):
    """The one-hot f32 matmul gather."""
    return probes.probe_gather(v, idx)


# (the JAX script's name, label, function, kernel): its six probes in its order
PROBES = (
    ("v_ref[i_ref[:]]", "k1", k1, "K6"),
    ("jnp.take(v, idx, axis=0)", "k2", k2, "K6"),
    ("take_along_axis axis=0", "k3", k3, "K6"),
    ("scalar fori_loop rows", "k4", k4, "K6"),
    ("o_ref[idx] += delta", "k5", k5, "K7"),
    ("one-hot matmul gather", "k6", k6, "K6"),
)


def _plain(kernel, args):
    return (probes._probe_scatter_plain if kernel == "K7" else probes._probe_gather_plain)(*args)


def main(device="cuda", iters=50):
    """Every probe on ``device``. Returns one dict per probe: its labels, function,
    kernel, arguments and output, its largest difference from the plain version, its ms
    per call and ``torch.index_select``'s."""
    v, idx, d = inputs(device)
    rows = []
    for name, label, fn, kernel in PROBES:
        args = (v, idx, d) if kernel == "K7" else (v, idx)
        out = fn(*args)
        err = float((out - _plain(kernel, args)).abs().max())
        ms = time_ms(lambda: fn(*args), iters, device)
        lib_ms = time_ms(lambda: torch.index_select(v, 0, idx), iters, device)
        status = "OK  " if err == 0.0 else "FAIL"
        print(f"{status} {name}: {out.cpu().numpy().ravel()[:4]}  ({label} through {kernel}: "
              f"{ms:.4f} ms, torch.index_select {lib_ms:.4f} ms; max |diff| vs plain {err:g})")
        rows.append(dict(name=name, label=label, fn=fn, kernel=kernel, args=args, out=out,
                         max_abs_err=err, ms=ms, library_ms=lib_ms))
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    main(args.device, args.iters)
