"""Shard failure/recovery schedules.

A fault kills every instance of one logical shard at ``t_fail`` (their
in-flight and queued jobs are aborted and re-routed by the router to
surviving replica owners) and optionally revives them at ``t_recover``
with **cold caches** — the re-warm after recovery is part of what the
scenario measures.  With data replication R >= 2 a failure degrades tail
latency but never recall: every key is still owned by a live shard and
replica scans return identical results.

The port's own copy of ``repro.sim.faults``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses

from repro_torch.sim.kernel import Kernel


@dataclasses.dataclass(frozen=True)
class ShardFault:
    """One shard goes down at ``t_fail`` (back at ``t_recover``, if set)."""

    shard: int
    t_fail: float
    t_recover: float | None = None

    def __post_init__(self):
        if self.shard < 0:
            raise ValueError(f"shard must be >= 0, got {self.shard}")
        if self.t_fail < 0:
            raise ValueError(f"t_fail must be >= 0, got {self.t_fail}")
        if self.t_recover is not None and self.t_recover <= self.t_fail:
            raise ValueError(
                f"t_recover ({self.t_recover}) must be after t_fail "
                f"({self.t_fail})")

    @classmethod
    def parse(cls, spec: str) -> "ShardFault":
        """Parse the CLI form ``shard:t_fail[:t_recover]``."""
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"fault spec {spec!r} is not shard:t_fail[:t_recover]")
        return cls(shard=int(parts[0]), t_fail=float(parts[1]),
                   t_recover=float(parts[2]) if len(parts) == 3 else None)

    def to_dict(self) -> dict:
        return dict(shard=self.shard, t_fail=self.t_fail,
                    t_recover=self.t_recover)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    faults: tuple[ShardFault, ...]

    @classmethod
    def parse(cls, specs) -> "FaultSchedule":
        return cls(tuple(ShardFault.parse(s) for s in specs))

    def install(self, kernel: Kernel, fleet) -> None:
        """Schedule the kill/revive events against a fleet router (any
        object with ``fail_shard(shard)`` / ``recover_shard(shard)``)."""
        for f in self.faults:
            kernel.at(f.t_fail, fleet.fail_shard, f.shard)
            if f.t_recover is not None:
                kernel.at(f.t_recover, fleet.recover_shard, f.shard)

    def to_dicts(self) -> list[dict]:
        return [f.to_dict() for f in self.faults]
