"""Storage environment specifications (paper Table 1 + §2.2).

These constants parameterise the discrete-event I/O simulator; the presets
are the paper's measured environments.

The port's own copy of ``repro.storage.spec``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StorageSpec:
    name: str
    ttfb_p50_s: float              # time-to-first-byte, median
    ttfb_sigma: float              # lognormal sigma for the latency tail
    bandwidth_Bps: float           # read throughput (shared pipe, bytes/s)
    get_qps_limit: float           # GET request rate limit (IOPS throttle)
    min_latency_s: float = 0.0     # hard floor (e.g. kernel I/O stack)

    def describe(self) -> str:
        return (f"{self.name}: p50 TTFB {self.ttfb_p50_s*1e6:.1f}us, "
                f"{self.get_qps_limit:.0f} GET QPS, "
                f"{self.bandwidth_Bps/2**30:.3f} GiB/s")


# Paper Table 1 (experiment section uses p50=31ms for the external-network
# TOS path, §5.1; Table 1 lists 9ms for the storage itself — we expose both).
TOS = StorageSpec(
    name="volcano-tos",
    ttfb_p50_s=9e-3,
    ttfb_sigma=0.55,               # 30-200ms cold tail (§2.2)
    bandwidth_Bps=0.625e9,         # 5 Gbps external network
    get_qps_limit=20_000.0,
)

TOS_EXTERNAL = dataclasses.replace(
    TOS, name="volcano-tos-external", ttfb_p50_s=31e-3)

SSD = StorageSpec(
    name="local-ssd",
    ttfb_p50_s=66.5e-6,
    ttfb_sigma=0.25,
    bandwidth_Bps=12e9,
    get_qps_limit=420_000.0,
)

# Per-shard local NVMe used as a middle tier between the DRAM segment
# cache and the remote object store (repro_torch.storage.tier): ~100us base
# latency (TTFB median + kernel I/O floor), with its own IOPS bucket and
# bandwidth pipe so an NVMe-resident working set never touches the
# remote NIC or GET tokens.
NVME = StorageSpec(
    name="local-nvme",
    ttfb_p50_s=90e-6,
    ttfb_sigma=0.25,
    bandwidth_Bps=3.5e9,
    get_qps_limit=300_000.0,
    min_latency_s=10e-6,
)

S3_EXTERNAL = StorageSpec(
    name="s3-external",
    ttfb_p50_s=30e-3,
    ttfb_sigma=0.6,
    bandwidth_Bps=0.625e9,         # 5 Gbps
    get_qps_limit=5_500.0,         # per-prefix (paper §2.2)
)

INTERNAL_NIC = StorageSpec(
    name="tos-internal-50gbps",
    ttfb_p50_s=9e-3,
    ttfb_sigma=0.55,
    bandwidth_Bps=6.25e9,          # 50 Gbps on-premise internal network
    get_qps_limit=20_000.0,
)

PRESETS = {s.name: s for s in [TOS, TOS_EXTERNAL, SSD, NVME, S3_EXTERNAL,
                               INTERNAL_NIC]}
