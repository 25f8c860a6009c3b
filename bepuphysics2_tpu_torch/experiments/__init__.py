"""The TPU design probes of the repository's ``experiments/``, ported.

- ``sweep_proto``: the sweep prototypes v1-v4 (``experiments/pallas_sweep_proto*.py``)
  through kernel K5: ``python3 -m bepuphysics2_tpu_torch.experiments.sweep_proto``.
- ``gather_probe``: the gather and scatter probes k1-k6
  (``experiments/pallas_gather_probe.py``) through kernels K6 and K7:
  ``python3 -m bepuphysics2_tpu_torch.experiments.gather_probe``.

Each runs on the CUDA card unless given ``--device cpu``, where the kernels' plain
versions run. Nothing of ``experiments/`` is imported: the inputs are rebuilt here from
the same numpy seeds.
"""
import time

import torch


def time_ms(fn, reps, device):
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up call: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps
