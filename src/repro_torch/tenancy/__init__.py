"""``repro_torch.tenancy`` — multi-tenant fleets with shared shard caches.

The paper's last study shows cache behaviour dominates cloud-native
search economics (§7); a provider amortises one cache fleet across many
tenants, so *who gets the cache* becomes the deciding policy question.
This subsystem serves N tenant workloads — each with its own corpus,
index kind, arrival process, write rate and SLO — over one shard fleet:

* ``spec`` — :class:`TenantSpec`, the ``--tenants spec.json`` schema;
* ``policy`` — cache-sharing strategies per instance: fully ``shared``
  SLRU, ``static`` per-tenant byte partitions, ``weighted`` quotas with
  ghost-list-driven adaptive reallocation;
* ``fleet`` — :class:`MultiTenantRouter` /
  :func:`run_tenant_fleet` (tenant contexts over the shared
  scatter-gather router) and :func:`measure_interference` (p99 solo vs
  shared);
* ``metrics`` — per-tenant report slices + the fleet aggregate.

CLI: ``python -m repro_torch.fleet --tenants spec.json --cache-policy
weighted``.  A single closed-loop tenant under ``shared`` reproduces
the plain fleet reports bit-exactly (golden-parity chain); stochastic
arrival kinds draw from tenant-named RNG streams, so their tenancy
runs are deterministic but not sample-identical to the plain path.

The port's own copy of ``repro.tenancy``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from repro_torch.tenancy.fleet import (MultiTenantRouter, Tenant,
                                       fair_share_windows, materialize_tenant,
                                       measure_interference, run_tenant_fleet)
from repro_torch.tenancy.metrics import MultiTenantReport, TenantSlice
from repro_torch.tenancy.policy import (TENANT_CACHE_POLICIES, SharedTenantCache,
                                        StaticTenantCache, WeightedTenantCache,
                                        make_tenant_cache)
from repro_torch.tenancy.spec import TenantSpec, load_tenant_specs

__all__ = [
    "TenantSpec", "load_tenant_specs",
    "TENANT_CACHE_POLICIES", "make_tenant_cache",
    "SharedTenantCache", "StaticTenantCache", "WeightedTenantCache",
    "Tenant", "materialize_tenant", "fair_share_windows",
    "MultiTenantRouter", "run_tenant_fleet", "measure_interference",
    "TenantSlice", "MultiTenantReport",
]
