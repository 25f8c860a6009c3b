"""Hand-written CUDA kernels for NVIDIA Hopper, with their plain PyTorch versions.

- ``sweep``: kernel K1, the whole substepped contact solve in one launch
  (``csrc/substeps_contacts.cu``), and the packed contact-row contract it reads.
- ``build``: builds ``csrc/*.cu`` with ``nvcc`` at first use and loads it with ctypes.
"""
from . import sweep  # noqa: F401
