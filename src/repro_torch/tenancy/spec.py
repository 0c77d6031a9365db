"""Declarative tenant workloads (the ``--tenants spec.json`` schema).

A :class:`TenantSpec` is one tenant's :class:`~repro_torch.tuning.space.
WorkloadSpec`-style contract with the shared fleet: dataset scale and
index kind (its own corpus and sealed index), arrival process (any
:mod:`repro_torch.sim.arrivals` scenario kind), write rate (its own update
stream + compaction schedule), recall/latency SLO, and a *weight* — its
share of the fleet's admission window and cache budget under the
``static``/``weighted`` sharing policies.

The port's own copy of ``repro.tenancy.spec``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.sim.arrivals import ARRIVAL_KINDS, Scenario

INDEX_KINDS = ("cluster", "graph")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's workload contract (all fields JSON-serialisable)."""

    name: str
    # dataset / index
    n: int = 2000
    dim: int = 64
    index: str = "cluster"             # "cluster" | "graph"
    n_queries: int = 64
    k: int = 10
    nprobe: int = 16                   # cluster search knob
    search_len: int = 40               # graph search knobs
    beamwidth: int = 8
    # arrival process (repro_torch.sim.arrivals Scenario axes)
    scenario: str = "closed"
    rate_qps: float = 200.0
    duration_s: float | None = None
    n_arrivals: int | None = None
    burst_factor: float = 4.0
    burst_start_s: float = 0.25
    burst_len_s: float = 0.25
    zipf_a: float = 1.2
    # write path
    write_rate_qps: float = 0.0
    n_updates: int | None = None
    delete_frac: float = 0.2
    delta_kb: float = 256.0            # memtable capacity per site
    flush_frac: float = 0.5            # flush trigger (fraction of cap)
    compaction_par: int = 1            # concurrent compaction jobs/site
    # SLOs + fair share
    slo_ms: float = 50.0
    target_recall: float = 0.9
    weight: float = 1.0
    seed: int | None = None            # dataset/build seed (None: derived)

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant needs a name")
        if self.index not in INDEX_KINDS:
            raise ValueError(f"tenant {self.name!r}: index must be one of "
                             f"{INDEX_KINDS}, got {self.index!r}")
        if self.scenario not in ARRIVAL_KINDS:
            raise ValueError(
                f"tenant {self.name!r}: scenario must be one of "
                f"{ARRIVAL_KINDS}, got {self.scenario!r}")
        if self.n < 8:
            raise ValueError(f"tenant {self.name!r}: n must be >= 8")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")
        if self.slo_ms <= 0:
            raise ValueError(f"tenant {self.name!r}: slo_ms must be > 0")

    @property
    def slo_s(self) -> float:
        return self.slo_ms * 1e-3

    def scenario_obj(self) -> Scenario:
        """This tenant's arrival scenario (reuses the fleet-wide axis)."""
        return Scenario(
            kind=self.scenario, rate_qps=self.rate_qps,
            duration_s=self.duration_s, n_arrivals=self.n_arrivals,
            burst_factor=self.burst_factor,
            burst_start_s=self.burst_start_s, burst_len_s=self.burst_len_s,
            zipf_a=self.zipf_a, slo_s=self.slo_s,
            write_rate_qps=self.write_rate_qps, n_updates=self.n_updates,
            delete_frac=self.delete_frac)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown tenant-spec fields {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**d)


def load_tenant_specs(path: str) -> list[TenantSpec]:
    """Parse a ``--tenants`` JSON file: a list of tenant objects (or
    ``{"tenants": [...]}``)."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        payload = payload.get("tenants", payload)
    if not isinstance(payload, list) or not payload:
        raise ValueError(f"{path}: expected a non-empty list of tenant "
                         f"objects")
    specs = [TenantSpec.from_dict(d) for d in payload]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in {path}: {names}")
    return specs
