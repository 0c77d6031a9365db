"""Actionable index selection & tuning on the PyTorch port — a thin
client of ``repro_torch.tuning`` (RQ1/RQ2/RQ3 as a decision system).

The port's counterpart of ``examples/cloud_tuning.py``, with its flags and
its printed lines.  For each (workload, environment) pair the auto-tuner
enumerates the joint {index class} × {build} × {search} × {cache policy}
space, prunes ≥90% of it with the paper's analytic cost models, and
(optionally) refines the survivors on the real engine + storage simulator
before recommending.  The screen is host arithmetic; ``--simulate`` builds
the rungs' indexes and ground truths on ``--device`` (default: the card;
without one this raises, so pass ``--device cpu`` for the plain PyTorch
versions).

    PYTHONPATH=src python examples/torch/cloud_tuning.py [--device cpu]
    PYTHONPATH=src python examples/torch/cloud_tuning.py --simulate

For one-off tuning with JSON output use the CLI directly:

    PYTHONPATH=src python -m repro_torch.tuning --recall 0.95 \
        --concurrency 64 --dim 960 --storage tos
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.tuning import (EnvSpec, EvalBudget, WorkloadSpec, autotune,
                                resolve_storage)

WORKLOADS = [
    ("adhoc-recs", WorkloadSpec(n=10_000_000, dim=96, dtype="float32",
                                target_recall=0.9, concurrency=1)),
    ("agentic-rag", WorkloadSpec(n=1_000_000, dim=960, dtype="float32",
                                 target_recall=0.995, concurrency=64,
                                 query_dist="zipf")),
    ("ecommerce", WorkloadSpec(n=100_000_000, dim=128, dtype="int8",
                               target_recall=0.95, concurrency=16)),
    ("fraud-high-recall", WorkloadSpec(n=1_000_000, dim=960,
                                       dtype="float32", target_recall=0.99,
                                       concurrency=4)),
]


def main(argv=None) -> list:
    """Run the tuner over every (environment, workload); returns the
    recommendations in the order printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--simulate", action="store_true",
                    help="refine screen survivors on the real simulator "
                         "(slower, higher fidelity)")
    ap.add_argument("--cache-gb", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="where --simulate builds its indexes (default: "
                         "cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    budget = EvalBudget(rungs=((400, 16),), max_rung0=6) \
        if args.simulate else "screen"
    recs = []
    for env_name in ["tos", "ssd"]:
        env = EnvSpec(storage=resolve_storage(env_name),
                      cache_bytes=int(args.cache_gb * 2**30))
        print(f"\n=== environment: {env.describe()} ===")
        for name, w in WORKLOADS:
            rec = autotune(w, env, budget=budget, device=device)
            recs.append(rec)
            print(f"  {name:20s} recall>={w.target_recall} "
                  f"conc={w.concurrency:3d} -> {rec.config.label()}")
            print(f"      predicted: {rec.pred_qps:9.1f} QPS at recall "
                  f"{rec.pred_recall:.3f} (screen kept "
                  f"{rec.screen_kept}/{rec.screen_total})")
            for t in rec.tips:
                print(f"      - {t}")
    return recs


if __name__ == "__main__":
    main()
