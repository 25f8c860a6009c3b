"""Hand-written CUDA kernels for NVIDIA Hopper, with their plain PyTorch versions.

- ``sweep``: the contact-solve kernels and the packed contact-row contract they read. K1
  (``csrc/substeps_contacts.cu``) and K2, its windowed variant
  (``csrc/substeps_contacts_win.cu``), each run the whole substepped contact solve in one
  launch; K3 (``csrc/contact_sweep.cu``) and K4, its windowed variant
  (``csrc/contact_sweep_win.cu``), run one contact bank's velocity iterations of one
  substep on the general path. All four include the per-row math of
  ``csrc/contact_rows.cuh``.
- ``probes``: the TPU design probes of ``experiments/``: K5 (``csrc/probe_sweep.cu``),
  the sweep prototypes' passes with the body state in shared memory; K6
  (``csrc/probe_gather.cu``), a row gather; K7 (``csrc/probe_scatter.cu``), a
  last-writer scatter.
- ``build``: builds ``csrc/*.cu`` with ``nvcc`` at first use and loads it with ctypes.
"""
from . import probes, sweep  # noqa: F401
