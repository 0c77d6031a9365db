"""repro_torch.obs — tracing, metrics, live monitoring, and cost.

Observability for the simulated serving stack: simulated-time span
trees (:mod:`~repro_torch.obs.trace`), a fixed-memory metrics registry
(:mod:`~repro_torch.obs.metrics`), Chrome-trace/Perfetto export
(:mod:`~repro_torch.obs.export`), per-query critical-path attribution and
run-to-run trace diffs (:mod:`~repro_torch.obs.critical_path`),
self-describing run manifests (:mod:`~repro_torch.obs.manifest`), live SLO
monitors with burn-rate alerting (:mod:`~repro_torch.obs.monitor`),
dollar-denominated cost metering with per-tenant show-back
(:mod:`~repro_torch.obs.cost`), tail-latency exemplars with deterministic
``explain_tail`` reports (:mod:`~repro_torch.obs.explain`), and online
miss-ratio-curve profiling via SHARDS spatial sampling
(:mod:`~repro_torch.obs.mrc`).

The cardinal rule: observing never perturbs.  A run with a tracer,
monitor or price book attached is bit-exact against the same run
without them — only the opt-in alert->action bus (``--alert-actions``)
may change a schedule, and then on purpose.

The port's own copy of ``repro.obs``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from repro_torch.obs.cost import (PRICEBOOKS, PriceBook, fleet_cost,
                            format_showback, resolve_pricebook,
                            tenant_showback)
from repro_torch.obs.critical_path import (AttributionReport, attribute,
                                     extract_paths, render_diff,
                                     trace_diff)
from repro_torch.obs.explain import (ExplainCollector, ExplainConfig,
                               render_explain)
from repro_torch.obs.export import chrome_trace, flame_summary, write_chrome_trace
from repro_torch.obs.manifest import run_manifest
from repro_torch.obs.mrc import MRCConfig, MRCProfiler, mrc_miss_ratio
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.monitor import (DEFAULT_RULES, ActionBus, Alert, AlertLog,
                               BurnRateRule, FleetMonitor, MonitorConfig,
                               SLOMonitor)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "MetricsRegistry",
    "chrome_trace", "write_chrome_trace", "flame_summary",
    "attribute", "extract_paths", "AttributionReport",
    "trace_diff", "render_diff",
    "run_manifest",
    "MonitorConfig", "FleetMonitor", "SLOMonitor", "BurnRateRule",
    "Alert", "AlertLog", "ActionBus", "DEFAULT_RULES",
    "PriceBook", "PRICEBOOKS", "resolve_pricebook",
    "fleet_cost", "tenant_showback", "format_showback",
    "ExplainConfig", "ExplainCollector", "render_explain",
    "MRCConfig", "MRCProfiler", "mrc_miss_ratio",
]
