"""Hand-written CUDA kernels for NVIDIA Hopper, with their plain PyTorch versions.

- ``sweep``: kernels K1 (``csrc/substeps_contacts.cu``) and K2, its windowed variant
  (``csrc/substeps_contacts_win.cu``), each the whole substepped contact solve in one
  launch, with the packed contact-row contract they read and their plain versions. Both
  include the per-row math of ``csrc/contact_rows.cuh``.
- ``build``: builds ``csrc/*.cu`` with ``nvcc`` at first use and loads it with ctypes.
"""
from . import sweep  # noqa: F401
