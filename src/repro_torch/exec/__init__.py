"""repro_torch.exec — batched execution of the port's kernels and their
measured pricing.

* :mod:`repro_torch.exec.batched` — pad-to-tile batched execution of the
  fused top-k kernel;
* :mod:`repro_torch.exec.calibrate` — times the kernels on the card over a
  (dim, pq_m, batch) grid and persists a :class:`CalibrationTable`
  (:mod:`repro_torch.exec.table`; the committed default was measured on an
  H100);
* :mod:`repro_torch.exec.backend` — the per-shard :class:`KernelBackend`
  coalescer that batches concurrent jobs within a window and prices them
  from the table (``--backend kernel`` on ``python -m repro_torch.fleet``).
"""
from repro_torch.exec.backend import KernelBackend
from repro_torch.exec.batched import (CAND_TILE, QUERY_TILE, batched_topk,
                                      coalesce_scan, pad_amount,
                                      scan_topk_oracle)
from repro_torch.exec.calibrate import measure_table
from repro_torch.exec.table import (CALIBRATE_COMMAND, DEFAULT_TABLE_PATH,
                                    CalibEntry, CalibrationTable, load_table)

__all__ = ["KernelBackend",
           "QUERY_TILE", "CAND_TILE", "pad_amount",
           "batched_topk", "scan_topk_oracle", "coalesce_scan",
           "measure_table",
           "CalibEntry", "CalibrationTable", "CALIBRATE_COMMAND",
           "DEFAULT_TABLE_PATH", "load_table"]
