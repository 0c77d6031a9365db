"""The card's published peaks, and its name and power limit as nvidia-smi
reports them.

One table for every roofline in the port: ``chip_smoke.py``'s kernel bounds
and the calibration harness's cross-check (:mod:`repro_torch.exec.calibrate`)
both read it.
"""
from __future__ import annotations

import subprocess

# (FP32 FLOP/s outside the tensor cores, memory bytes/s) of the SXM parts
# from NVIDIA's data sheets, by torch.cuda.get_device_name(); the rates
# assume the 700 W power limit, which smi_line() reports beside them.
PEAKS = (("H100 80GB HBM3", 67e12, 3.35e12), ("H200", 67e12, 4.8e12))


def card_peaks(name: str) -> tuple[float, float]:
    """``(fp32 FLOP/s, bytes/s)`` of the card called ``name``."""
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise ValueError(f"no data-sheet peak for the card {name!r}")


def smi_line(index: int = 0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of card ``index``."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
