"""repro_torch.exec — batched execution of the port's kernels and their
measured pricing.

* :mod:`repro_torch.exec.batched` — pad-to-tile batched execution of the
  fused top-k kernel;
* :mod:`repro_torch.exec.calibrate` — times the kernels on the card over a
  (dim, pq_m, batch) grid and persists a :class:`CalibrationTable`
  (:mod:`repro_torch.exec.table`).

The coalescing backend (``repro.exec.backend``) comes with the fleet slice,
its only user.
"""
from repro_torch.exec.batched import (CAND_TILE, QUERY_TILE, batched_topk,
                                      coalesce_scan, pad_amount,
                                      scan_topk_oracle)
from repro_torch.exec.calibrate import measure_table
from repro_torch.exec.table import (CALIBRATE_COMMAND, CalibEntry,
                                    CalibrationTable, load_table)

__all__ = ["QUERY_TILE", "CAND_TILE", "pad_amount",
           "batched_topk", "scan_topk_oracle", "coalesce_scan",
           "measure_table",
           "CalibEntry", "CalibrationTable", "CALIBRATE_COMMAND", "load_table"]
