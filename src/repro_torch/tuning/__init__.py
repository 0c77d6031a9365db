"""``repro_torch.tuning`` — the port's part of ``repro.tuning``.

Only the declarative search space (:mod:`repro_torch.tuning.space`) is
ported so far: ``python -m repro_torch.fleet`` resolves its ``--storage``
preset through it.  The screen, the successive-halving evaluation, the
fleet, tier, cache-split and ingest tuners and ``python -m
repro_torch.tuning`` are still to be ported.
"""
from repro_torch.tuning.space import (STORAGE_ALIASES, Candidate, EnvSpec,
                                      WorkloadSpec, enumerate_space,
                                      resolve_storage)

__all__ = ["STORAGE_ALIASES", "Candidate", "EnvSpec", "WorkloadSpec",
           "enumerate_space", "resolve_storage"]
