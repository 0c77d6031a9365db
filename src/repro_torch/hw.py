"""The card's published peaks, and its name and power limit as nvidia-smi
reports them.

One table for every roofline in the port: ``chip_smoke.py``'s kernel bounds,
the calibration harness's cross-check (:mod:`repro_torch.exec.calibrate`)
and the dry-run's roofline (:mod:`repro_torch.launch.roofline`) read it.
"""
from __future__ import annotations

import subprocess

# (FP32 FLOP/s outside the tensor cores, memory bytes/s, dense BF16
# tensor-core FLOP/s, NVLink bytes/s each way, network bytes/s) of the SXM
# parts from NVIDIA's data sheets, by torch.cuda.get_device_name(); the
# rates assume the 700 W power limit, which smi_line() reports beside them.
# NVLink 4 joins the cards of a node at 900 GB/s both ways (450 GB/s each
# way a card); across nodes a DGX gives each card one 400 Gb/s NIC (50
# GB/s).
PEAKS = (("H100 80GB HBM3", 67e12, 3.35e12, 989e12, 450e9, 50e9),
         ("H200", 67e12, 4.8e12, 989e12, 450e9, 50e9))


def _row(name: str) -> tuple:
    for row in PEAKS:
        if row[0] in name:
            return row
    raise ValueError(f"no data-sheet peak for the card {name!r}")


def card_peaks(name: str) -> tuple[float, float]:
    """``(fp32 FLOP/s, bytes/s)`` of the card called ``name``."""
    return _row(name)[1:3]


def card_bf16_peak(name: str) -> float:
    """Dense BF16 tensor-core FLOP/s of the card called ``name``."""
    return _row(name)[3]


def card_links(name: str) -> tuple[float, float]:
    """``(NVLink bytes/s, network bytes/s)`` each way of one card called
    ``name``: a collective inside a node, and one across nodes."""
    return _row(name)[4:6]


def smi_line(index: int = 0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of card ``index``."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
