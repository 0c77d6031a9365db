"""Default-device resolution for the port's entry points.

Entry points run on the card.  A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; without CUDA and without that, the
call raises instead of silently running the plain versions on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")
