"""The sweep prototypes v1-v4 of ``experiments/pallas_sweep_proto*.py`` through kernel K5.

Each prototype measured what one Gauss-Seidel pass costs with the body state held on
chip: 36 passes, each gathering M = 1,024 of NB = 4,096 body rows of 8 floats, running a
fixed arithmetic block on them and adding the results back. Here every variant runs K5
(``ops/probes.py`` ``probe_sweep``), one block walking the passes with the state in
shared memory, in the prototype's own state layout:

- ``sweep_v1`` (``pallas_sweep_proto.py``): chunk-major (32, 1024), L = 128;
- ``build_v2(mode)`` (``pallas_sweep_proto2.py``): the same, modes A-D (A is B, the
  sweep; C gathers and computes without the scatter; D gathers component 0 of the row's
  chunk's first 8 bodies instead of the row's own);
- ``sweep_v3`` (``pallas_sweep_proto3.py``): transposed (1024, 32), L = 128;
- ``sweep_v4`` (``pallas_sweep_proto4.py``): transposed (64, 512), L = 8. The TPU kernel
  took one-hot operands built from the indices; this one takes the indices.

    python3 -m bepuphysics2_tpu_torch.experiments.sweep_proto [--device cpu]

prints, per variant, the largest difference from the plain version and the time per call
over 50 calls as microseconds per pass. The inputs are the prototypes' own (numpy seed 0,
``rng.permutation(NB)[:M]`` per pass), at their full size.
"""
import argparse
import time

import numpy as np
import torch

from ..ops import probes
from . import time_ms

NB = 4096
CAP = 512
M = 2 * CAP  # rows touched per pass
PASSES = 36


def to_v2(v6):
    """(NB, 8) -> (NB/128, 1024): component c of body k·128+l at [k, c·128+l]."""
    return probes.to_state(v6, 128, False)


def from_v2(v2):
    return probes.to_rows(v2, 128, False)


def to_vt(v6, lanes=128):
    """(NB, 8) -> (8L, NB/L): component c of body k·L+l at [c·L+l, k]."""
    return probes.to_state(v6, lanes, True)


def from_vt(vt, lanes=128):
    return probes.to_rows(vt, lanes, True)


def sweep_v1(v2, idx):
    """Counterpart of ``pallas_sweep`` in ``experiments/pallas_sweep_proto.py``."""
    return probes.probe_sweep(v2, idx, lanes=128, transposed=False)


def build_v2(mode):
    """Counterpart of ``build(mode)`` in ``experiments/pallas_sweep_proto2.py``."""
    if mode not in probes.MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(probes.MODES)}")

    def fn(v2, idx):
        return probes.probe_sweep(v2, idx, lanes=128, transposed=False, mode=mode)

    return fn


def sweep_v3(vt, idx):
    """Counterpart of ``pallas_sweep`` in ``experiments/pallas_sweep_proto3.py``."""
    return probes.probe_sweep(vt, idx, lanes=128, transposed=True)


def sweep_v4(vt, idx):
    """Counterpart of ``pallas_sweep`` in ``experiments/pallas_sweep_proto4.py``, which
    took ``build_onehots(idx)`` where this takes ``idx``."""
    return probes.probe_sweep(vt, idx, lanes=8, transposed=True)


# (name, function, lanes, transposed, mode): every variant the four prototypes' mains run
VARIANTS = (
    ("v1", sweep_v1, 128, False, "B"),
    ("v2-A", build_v2("A"), 128, False, "A"),
    ("v2-B", build_v2("B"), 128, False, "B"),
    ("v2-C", build_v2("C"), 128, False, "C"),
    ("v2-D", build_v2("D"), 128, False, "D"),
    ("v3", sweep_v3, 128, True, "B"),
    ("v4", sweep_v4, 8, True, "B"),
)


def inputs():
    """The prototypes' inputs: (NB, 8) normal state and (PASSES, M) int32 body lists,
    each pass a slice of a permutation (no body twice in a pass); numpy seed 0."""
    rng = np.random.default_rng(0)
    v6 = rng.normal(size=(NB, 8)).astype(np.float32)
    idx = np.stack([rng.permutation(NB)[:M] for _ in range(PASSES)]).astype(np.int32)
    return v6, idx


def inputs_with_duplicates():
    """As ``inputs``, but each pass draws its bodies with replacement (numpy seed 1):
    about a tenth of a pass's rows repeat a body."""
    rng = np.random.default_rng(1)
    v6 = rng.normal(size=(NB, 8)).astype(np.float32)
    return v6, rng.integers(0, NB, (PASSES, M)).astype(np.int32)


def main(device="cuda", iters=50):
    """What the four prototypes' mains do, on ``device``: every variant over the
    prototypes' inputs. Returns one dict per variant: its name, function, layout and
    mode, input state and indices, output, the plain version's host-clock ms, the largest
    difference from the plain version, and the ms per call over ``iters`` calls with its
    microseconds per pass."""
    on_card = torch.device(device).type == "cuda"
    print(f"sweep prototypes through K5 on {torch.cuda.get_device_name(0) if on_card else 'cpu'}"
          f": NB {NB}, M {M}, {PASSES} passes")
    v6, idx = inputs()
    idx = torch.from_numpy(idx).to(device)
    rows = []
    for name, fn, lanes, transposed, mode in VARIANTS:
        state = probes.to_state(torch.from_numpy(v6), lanes, transposed).to(device)
        out = fn(state, idx)
        _sync(on_card)
        t0 = time.perf_counter()
        want = probes._probe_sweep_plain(state, idx, lanes, transposed, mode)
        _sync(on_card)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((out - want).abs().max())
        ms = time_ms(lambda: fn(state, idx), iters, device)
        rows.append(dict(name=name, fn=fn, lanes=lanes, transposed=transposed, mode=mode,
                         state=state, idx=idx, out=out, max_abs_err=err, plain_ms=plain_ms,
                         ms=ms, us_per_pass=ms * 1e3 / PASSES))
        print(f"{name:5s} ({'transposed' if transposed else 'chunk-major'}, L {lanes}, mode "
              f"{mode}): max |diff| vs plain {err:.3e}; {ms:8.4f} ms / {PASSES} passes = "
              f"{ms * 1e3 / PASSES:8.3f} us/pass (over {iters} calls); plain {plain_ms:.2f} ms")
    return rows


def _sync(on_card):
    if on_card:
        torch.cuda.synchronize()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    main(args.device, args.iters)
