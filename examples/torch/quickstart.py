"""Quickstart on the PyTorch port: build both index classes, serve a
workload on simulated cloud storage, and compare against the paper's cost
model.

The port's counterpart of ``examples/quickstart.py``, with its flags and
its printed lines.  The cluster build's closure and the exact ground truth
run ``l2_topk``, and every round of a graph query runs ``adc_lookup``, on
``--device`` (default: the card; without one this raises, so pass
``--device cpu`` for the plain PyTorch versions).  The serving report is
virtual time, so both devices print the same lines up to kernel near-ties.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.cost_model import (ClusterWorkloadPoint,
                                         GraphWorkloadPoint,
                                         cluster_query_cost, graph_query_cost)
from repro_torch.core.flat import exact_topk
from repro_torch.core.graph_index import GraphIndex
from repro_torch.core.types import (ClusterIndexParams, GraphIndexParams,
                                    SearchParams)
from repro_torch.data.synth import DEEP_ANALOG, make_dataset, scaled
from repro_torch.device import resolve_device
from repro_torch.serving.engine import run_workload
from repro_torch.storage.spec import TOS


def main(argv=None) -> dict:
    """Run the quickstart; returns what it built (``data``, ``queries``,
    ``gt``, ``cluster``, ``graph`` and each index's ``reports``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the index builds, ground truth and ADC "
                         "lookups run (default: cuda; raises without a "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== dataset: deep-analog (96-D f32), 4000 vectors ==")
    spec = scaled(DEEP_ANALOG, 4000, 32)
    data, queries = make_dataset(spec)
    gt, _ = exact_topk(data, queries, 10, device=device)

    print("building SPANN-style cluster index...")
    ci = ClusterIndex.build(data, ClusterIndexParams(), device=device)
    print(f"  {ci.meta.n_lists} posting lists, "
          f"{ci.meta.index_bytes/1e6:.1f} MB, "
          f"avg list {ci.meta.avg_list_bytes/1e3:.1f} KB")

    print("building DiskANN-style graph index...")
    gi = GraphIndex.build(data, GraphIndexParams(R=32, L_build=64,
                                                 pq_dims=48), device=device)
    print(f"  {gi.meta.n_data} nodes x {gi.meta.node_nbytes} B blocks, "
          f"{gi.meta.index_bytes/1e6:.1f} MB")

    print(f"\nserving 32 queries on {TOS.describe()}")
    reports = {}
    for name, idx, sp in [
        ("SPANN  nprobe=32      ", ci, SearchParams(k=10, nprobe=32)),
        ("DiskANN L=80 W=8      ", gi,
         SearchParams(k=10, search_len=80, beamwidth=8)),
    ]:
        rep = run_workload(idx, queries, sp, TOS, concurrency=4)
        reports[name.split()[0].lower()] = rep
        recall = rep.recall_against(gt)
        print(f"  {name} recall={recall:.3f} qps={rep.qps:7.1f} "
              f"p50={rep.latency_percentile(50)*1e3:6.1f} ms "
              f"roundtrips={rep.mean_roundtrips:5.1f} "
              f"MB/q={rep.mean_bytes_read/1e6:6.2f}")

    print("\ncost-model predictions (paper Eq. 1 / Eq. 2):")
    cpred = cluster_query_cost(TOS, ClusterWorkloadPoint(
        n_lists=ci.meta.n_lists, avg_list_bytes=ci.meta.avg_list_bytes,
        avg_list_len=float(ci.meta.list_lengths.mean()), dim=spec.dim,
        nprobe=32))
    gpred = graph_query_cost(TOS, GraphWorkloadPoint(
        roundtrips=10, requests_per_round=8,
        node_nbytes=gi.meta.node_nbytes, R=32, pq_m=gi.meta.pq.m,
        dim=spec.dim))
    print(f"  cluster: total={cpred['total']*1e3:.1f} ms "
          f"(fetch {cpred['c_fetch']*1e3:.1f} / dist "
          f"{cpred['c_dist']*1e3:.2f})")
    print(f"  graph:   total={gpred['total']*1e3:.1f} ms "
          f"(ttfb {gpred['ttfb_total']*1e3:.1f})")
    return {"data": data, "queries": queries, "gt": gt, "cluster": ci,
            "graph": gi, "reports": reports}


if __name__ == "__main__":
    main()
