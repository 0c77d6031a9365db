"""repro_torch.exec — batched execution of the fused top-k kernel.

The port's :mod:`repro_torch.exec.batched`; the calibration table and the
coalescing backend come with a later slice.
"""
from repro_torch.exec.batched import (CAND_TILE, QUERY_TILE, batched_topk,
                                      coalesce_scan, pad_amount,
                                      scan_topk_oracle)

__all__ = ["QUERY_TILE", "CAND_TILE", "pad_amount",
           "batched_topk", "scan_topk_oracle", "coalesce_scan"]
