"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro``'s module paths and names.  Plain tensor code is PyTorch;
each Pallas TPU kernel of ``repro`` becomes a CUDA C++ kernel written for
``sm_90a`` (``repro_torch/kernels/csrc``), built with ``nvcc`` at its first
CUDA call and bound with ``ctypes``.  The package imports neither JAX nor
anything of ``repro``: where it needs a module of ``repro`` it keeps its own
copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`); on a CPU tensor every kernel wrapper takes
its plain PyTorch version instead (``repro_torch/kernels/ref.py``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
