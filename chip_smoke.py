#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths once on the card, and check them.

Two index paths, both on deep-analog data (DEEP10M's shape, 96-d float32),
and the LM serving and training paths:

* the SPANN cluster index on the device, at the size of the standard 1M
  ANN sets: 1,000,000 vectors and 10,000 queries;
* the DiskANN graph index at 100,000 vectors and 2,000 queries (cut from
  1M: the build's RobustPrune is host numpy, as in the reference; 100,000
  keeps the phases' sum under 1,000 s of the 1,200 s limit since step 14);
* retrieval-augmented generation with gemma-2b at its full width over a
  4,096-document corpus, and gemma-2b's training steps at that width;
* the four examples of ``examples/torch/`` as a user runs them, the 100M
  trainer at its full width.

1. build the four CUDA kernels from this checkout's sources (one nvcc
   each, all started together);
2. cluster path: host BKT (numpy), closure replication through the fused
   ``l2_topk`` kernel, ``device_arrays`` on the card; ground truth with
   ``exact_topk`` (``l2_topk``), k=10; ``device_search_batch`` at nprobe 16
   and 64 in batches of 512 (the centroid probe runs ``l2_distance``, its
   select and the merge's two top-k ``topk_select``, three launches a
   batch): recall@10 and queries/s; ``topk_select`` held to the plain
   stable sort, bit for bit, on the rows each of a batch's three top-k
   took at both nprobes, and on the benchmark cell's three shapes, each
   timed with its device time in L2 and with L2 flushed, against the
   bytes bound;
2b. ``core/distributed.py`` on one NCCL rank (a ``file://`` store): the
   sharded search step over the whole index (512 queries, nprobe_local 16,
   k=10; its probe runs ``l2_distance``) and a sharded k-means step (100,000
   points, 1,024 centroids), each held against the same step on the CPU
   through a ``gloo`` group, with the step's time and launches (the search
   step's probe, local top-k and merge: three ``topk_select``); one more
   search step under the profiler, whose trace
   ``launch/roofline.py``'s parser must read as its two all-gathers of
   512 x 10 x (4 + 4) bytes;
3. graph path: ``GraphIndex.build`` (R=24, L_build=48, one pass, 48 PQ
   subquantizers: the greedy search and PQ training on the card, the prune
   on the host); ground truth with ``exact_topk``; ``GraphIndex.search`` at
   beamwidth 8 and search_len 40 and 128 (every round's PQ distances run
   ``adc_lookup``): recall@10, queries/s, round trips, ADC rows;
4. hold each kernel against its plain PyTorch version on the card at the
   shapes the main paths gave it, and time kernel, plain version and the
   PyTorch library call where there is one (for ``l2_topk`` two calls,
   ``cdist`` then ``topk``, as context); ``l2_topk``'s share of the FP32
   bound with the variant and split it ran; both ``adc_lookup`` paths
   (staged table, direct reads) on the same codes, which must give the same
   bits, with each kernel's device time from the profiler and a CUDA
   graph's time a call, at the main paths' shapes and over a sweep of N;
   ``l2_distance``'s plan at the probe, its share of the bound, and the
   wide and simple instantiations held to the same bits (``torch.mm`` of
   the same operands timed as context);
5. the calibration harness (``measure_table``) on the card; its table is
   saved beside ``--out`` (or in a temporary directory) and prices the
   fleet phases;
6. the serving fleet (``repro_torch.fleet``): the cluster index of step 2
   and the graph index of step 3, each served 4 shards x 2 replicas over
   the ``tos`` object-storage preset with hedging and ``--backend kernel``
   priced from step 5's table (2,000 and 1,000 queries).  Routing, storage
   and virtual time are host simulation; a graph query's every round runs
   ``adc_lookup`` on the card.  The fleet's ids must equal the direct
   searches', and the graph fleet's ``adc_lookup`` launches must equal
   queries + round trips;
7. multi-tenancy (``repro_torch.tenancy``): both indexes as two tenants
   of one such fleet with a ``weighted`` 64 MiB cache a node
   (``measure_interference``: the shared run, then each tenant solo):
   ``search-hot`` (the cluster index, a Zipf trace at 500 queries/s) and
   ``analytics`` (the graph index, a burst at 50 queries/s).  Each tenant's
   ids must equal step 6's for the same query, and the graph tenant's
   ``adc_lookup`` launches its queries' own counts;
8. the write path (``repro_torch.ingest``) on the cluster index: the same
   fleet serves 2,000 queries under 400 inserts and deletes at 400/s with
   a 64 KiB delta tier a site.  Every update must be applied, the merged
   search must return no deleted id, and ``churn_ground_truth`` on the
   card (``l2_topk``) must give the plain version's ids up to near-ties;
9. the same on the graph index (1,000 queries, the medoid protected; the
   inserts are stitched in through ``adc_lookup``).  Steps 8-9 rewrite
   the indexes' stores, so they come last;
10. ``python -m repro_torch.fleet`` on the card as a user runs it (the
   committed calibration table): the cluster fleet twice, which must give
   the same JSON; the graph fleet, which must give the reference's 60.3254
   virtual queries/s; the write path (``--scenario rw``) and ``--tenants``,
   each of which must give one JSON; the five processes run at once (the
   ``--device cpu`` runs are the CPU parity tests',
   ``tests/test_torch_serving.py``);
11. the auto-tuner (``repro_torch.tuning``) at the CLI's defaults (n =
   1,000,000 screened, dim 960): first ``l2_topk`` at a rung's ground truth
   (56 x 3,000 x 960, k = 10; each call's device time beside the plain
   version's and ``cdist`` + ``topk``'s) and at a sweep's closure (1,200
   points x 256 centroids x 960, k = 8 and 4), and ``adc_lookup`` at m =
   120 on the direct path (4,096 rows) against their plain versions; then
   the seven commands of ``docs/tuning.md`` once each on the card, in this
   process so that the launch counts see the tuner's kernels (the rungs'
   and sweeps' builds and ground truths, a graph candidate's ADC rounds);
   ``--budget screen`` again with ``--device cpu`` (it measures no index,
   so it must give the card's JSON); and the quick index run as ``python
   -m repro_torch.tuning``, which must print one JSON;
12. retrieval-augmented generation (``launch/serve.py``'s pipeline) at
   gemma-2b's full width (18 layers, d_model 2,048, vocab 256,000, bf16
   activations over f32 weights drawn from seed 0 on the host): embed 4,096
   documents and 64 requests, ``ClusterIndex.build`` (closure through
   ``l2_topk`` at D = 2,048), ``run_workload`` over ``tos`` (recall@4
   against ``exact_topk`` at ``launch/serve.py``'s nprobe 8, and at 64 and every
   list on the same index, where the ids must be ``exact_topk``'s up to
   near-ties), 8 greedy tokens a request; prefill and decode
   time of 16 requests and one under the profiler; the logits of 4 held to
   the teacher-forced full forward in f32 (no TF32) and in bf16; ``l2_topk``
   at the closure's and the ground truth's shapes against its plain
   version; ``python -m repro_torch.launch.serve`` on the card runs in step
   14b (its ``--device cpu`` run is the CPU tests',
   ``tests/test_torch_lm_serve.py``);
13. training (``launch/train.py``'s ``build`` and ``train``, the runner,
   AdamW, remat) at gemma-2b's full width on step 12's weights: 6 steps at
   batch 8 x 256 tokens with finite losses and gradient norms, step 0's
   loss equal to ``lm.loss`` of its batch; ms a step (CUDA events),
   tokens/s, peak memory, the optimizer's share, one step under the
   profiler, whose trace holds no collective (one rank); the step's
   operations and bytes bounds, beside ``launch/roofline.py``'s terms of the
   same step (its analytic FLOPs and HBM bytes, the latter with the
   activations and the optimizer's traffic); a 1-layer model at
   gemma-2b's widths one step on the card against the CPU (f32); at the
   smoke config 30 steps with a falling loss, and a SIGTERM preemption
   whose resume ends on the uninterrupted run's parameters; ``python -m
   repro_torch.launch.train --smoke --steps 3`` on the card runs in step
   14b.  The training path launches none of the kernels;
14a. the smoke config trained 3 steps through the DTensor path
   (``models/parallel.py``) on an explicit 1x1 mesh over one NCCL rank,
   whose losses must equal the plain path's within 1e-6 relative;
14b. ``python -m repro_torch.launch.dryrun`` in three subprocesses (gemma-2b
   ``train_4k`` and ``decode_32k``, and ``--vector-search``), each one
   sharded step on a fake world of 256 ranks with fake tensors: status
   ``ok`` and a per-rank peak under the card's memory are required; the
   trace time, the FLOP count against the analytic FLOPs, the collectives
   and the roofline terms are printed.  The serve and train CLIs of steps
   12 and 13 run at the same time, five subprocesses in all;
15. the examples (``examples/torch/*.py``), each ``main([..., "--device",
   "cuda"])`` in this process: ``quickstart`` (``l2_topk`` and
   ``adc_lookup`` must launch) and ``rag_serving``, each also with
   ``--device cpu``, whose lines and retrieved documents the card's must
   equal up to near-ties; the ``cloud_tuning`` screen, whose lines must
   equal the CPU's; ``train_lm`` at its full 100M width, 150 steps at 8 x
   128 in a fresh ``--ckpt`` (its own "loss fell" check; ms a step, AdamW,
   tokens/s, peak memory, each checkpoint's seconds), then again on the
   same directory, which must resume at step 150 and run no step.

Launch counts are zeroed just before each main-path phase and read just
after it; the comparisons of steps 2 and 4 and the calibration are not
counted.
Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed check
exits nonzero before that line; so does a machine without CUDA, or a
directory without the rest of the repository.

    python3 chip_smoke.py [--n 1000000] [--queries 10000]
                          [--graph-n 100000] [--graph-queries 2000] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 512
K = 10
NPROBES = (16, 64)
TOL = 1e-5   # |kernel - plain| <= TOL * (|q|^2 + |x|^2): f32 cancellation bound
SEARCH_LENS = (40, 128)
BEAMWIDTH = 8
ADC_RTOL, ADC_ATOL = 1e-5, 1e-4   # the reference's (tests/test_kernels.py)
ADC_SWEEP_N = (256, 512, 1024, 2048, 4096, 8192, 16384)
FLEET_QUERIES, GRAPH_FLEET_QUERIES = 2000, 1000
CLI_TIMEOUT_S = 600


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.3f} s", flush=True)
    return now


def run_together(cmds: dict, env: dict, timeout: float) -> dict:
    """Start every argv of ``cmds`` at once from this checkout's root and
    wait for all of them: ``{name: (returncode, stdout, stderr, wall s from
    the common start to that process's end)}``.  The processes are
    independent (their own CUDA context, or none), so the phase takes the
    slowest one's time, not the sum.  Past ``timeout`` every process still
    running is killed, and so is any left when this raises."""
    root = Path(__file__).resolve().parent
    procs, ends = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procs_") as d:
        try:
            t0 = time.perf_counter()
            for name, argv in cmds.items():
                with open(Path(d, f"{name}.out"), "w") as fo, \
                        open(Path(d, f"{name}.err"), "w") as fe:
                    procs[name] = subprocess.Popen(argv, cwd=root, env=env,
                                                   stdout=fo, stderr=fe)
            while len(ends) < len(procs):
                for name, proc in procs.items():
                    if name not in ends and proc.poll() is not None:
                        ends[name] = time.perf_counter() - t0
                require(time.perf_counter() - t0 <= timeout,
                        f"{sorted(set(procs) - set(ends))} ran past "
                        f"{timeout} s")
                time.sleep(0.05)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return {name: (proc.returncode, Path(d, f"{name}.out").read_text(),
                       Path(d, f"{name}.err").read_text(), ends[name])
                for name, proc in procs.items()}


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, match, calls: int = 50) -> tuple[float | None, int]:
    """Mean device time of one kernel whose name satisfies ``match``, over
    ``calls`` calls of ``fn`` under ``torch.profiler``, and how many such
    kernels it recorded.  The mean divides by the recorded count: the
    profiler may drop records."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if match(e.key)]
    n = sum(e.count for e in ev)
    total_us = sum(e.self_device_time_total for e in ev)
    return (total_us / n / 1e3 if n else None), n


def graph_ms(fn, reps: int) -> float:
    """Device time a call of ``fn`` when ``reps`` calls replay as one CUDA
    graph: no host launch cost, but the gaps between kernels stay, so for a
    short kernel it is an upper bound of its own time."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del g
    return ms


def _kernels() -> dict:
    from repro_torch.kernels import distance, fused_topk, pq_adc, topk_select
    return {"l2_distance": distance.l2_distance, "l2_topk": fused_topk.l2_topk,
            "adc_lookup": pq_adc.adc_lookup,
            "topk_select": topk_select.topk_smallest}


def reset() -> None:
    """Zero every kernel's launch count."""
    for fn in _kernels().values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


def l2_bound_ms(Q: int, N: int, D: int, out_bytes: int, peaks) -> tuple[float, str]:
    """Least time for the squared-L2 work: operations (products, norms,
    combine) at the FP32 peak vs bytes (inputs once, output once)."""
    flops = 2 * Q * N * D + 2 * (Q + N) * D + 3 * Q * N
    nbytes = 4 * (Q + N) * D + out_bytes
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def queued_ms(fn, reps: int = 20, cycles: int = 200_000_000) -> float | None:
    """Device time a call of ``fn`` with the host out of the way: a sleep
    kernel holds the card while the host queues ``reps`` calls, and CUDA
    events time them as the card runs them back to back (the host's launch
    cost goes, the gaps between kernels stay).  None when the host took
    longer to queue the calls than the sleep lasted."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / reps


def topk_plan(Q: int, N: int, D: int, k: int) -> str:
    """The ``l2_topk`` variant, row split and resident blocks an SM the
    wrapper picks for a shape."""
    from repro_torch.kernels import fused_topk
    dev = torch.cuda.current_device()
    v, S, span = fused_topk.plan(Q, N, D, k, dev)
    per_sm = fused_topk._blocks_per_sm(fused_topk._lib(), v, D, k, dev)
    name = "wide" if v is fused_topk.WIDE else "narrow"
    return (f"{name} {v.block_q}x{v.block_n}, S={S} ranges of {span} rows, "
            f"{per_sm} block(s) an SM")


def two_call_topk(q: torch.Tensor, x: torch.Tensor, k: int):
    """The yardstick for ``l2_topk``: ``torch.cdist`` squared, then
    ``torch.topk`` (context: no single PyTorch call fuses distance and
    top-k); run it under ``full_f32_matmul``."""
    d = torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist")
    return torch.topk(d * d, k, dim=1, largest=False)


def two_call_topk_ms(q: torch.Tensor, x: torch.Tensor, k: int, reps: int) -> float:
    """Time of the two-call yardstick, in full f32."""
    from repro_torch.kernels.ref import full_f32_matmul
    with full_f32_matmul():
        ms = time_ms(lambda: two_call_topk(q, x, k), reps)
    torch.cuda.empty_cache()
    return ms


def topk_case(label: str, q: torch.Tensor, x: torch.Tensor, k: int, peaks,
              reps: tuple[int, int] = (0, 0), device: bool = False) -> dict:
    """``l2_topk`` against its plain version on one shape: values within each
    row's f32 tolerance, ids equal up to near-ties.  With ``reps`` (kernel,
    plain) it also times the kernel, the plain version and the two-call
    yardstick in a loop beside the bound and the plan; with ``device`` each
    of the three calls' device time (``queued_ms``) and the kernel's parts
    (profiler)."""
    from repro_torch.kernels import fused_topk
    from repro_torch.kernels.ref import full_f32_matmul, l2_topk_ref

    (Q, D), N = q.shape, x.shape[0]
    gv, gi = fused_topk.l2_topk(q, x, k)
    wv, wi = l2_topk_ref(q, x, k)
    row_tol = TOL * ((q * q).sum(-1) + (x * x).sum(-1).max()) + 1e-6
    err = float((gv - wv).abs().max())
    shape = f"{Q}x{N}x{D} k={k} ({label})"
    require(bool(((gv - wv).abs() <= row_tol[:, None]).all()),
            f"l2_topk at {shape}: values err {err}")
    n_diff, ties = near_tie_rows(gi, wi, q, x, row_tol)
    require(ties, f"l2_topk at {shape}: ids differ beyond near-ties in "
            f"{n_diff} rows")
    out = {"shape": shape, "max_abs_err": err, "rows_differing": n_diff}
    text = f"{n_diff} of {Q} rows differ, all near-ties; max abs err {err:.3g}"
    if reps[0]:
        b_ms, b_by = l2_bound_ms(Q, N, D, 8 * Q * k, peaks)
        out.update(plan=topk_plan(Q, N, D, k),
                   ms=time_ms(lambda: fused_topk.l2_topk(q, x, k), reps[0]),
                   plain_ms=time_ms(lambda: l2_topk_ref(q, x, k), reps[1]),
                   library_ms=two_call_topk_ms(q, x, k, reps[1]),
                   bound_ms=b_ms, bound_by=b_by)
        out["bound_share"] = b_ms / out["ms"]
        text = (f"({out['plan']}): kernel {out['ms']:.4f} ms, plain "
                f"{out['plain_ms']:.4f} ms, cdist+topk {out['library_ms']:.4f} "
                f"ms (two calls), bound {b_ms:.6f} ms ({b_by}), "
                f"{out['bound_share']:.3f} of it; " + text)
    if device:
        # where a call's device time goes (the row-norm pre-pass, the main
        # kernel, the merge of the S ranges), and each call's device time
        parts = {name: kernel_device_ms(lambda: fused_topk.l2_topk(q, x, k),
                                        lambda key, n=name: n in key)[0]
                 for name in ("row_norms_kernel", "l2_topk_kernel",
                              "merge_kernel")}
        with full_f32_matmul():
            lib_dev = queued_ms(lambda: two_call_topk(q, x, k))
        out.update(device_ms=queued_ms(lambda: fused_topk.l2_topk(q, x, k)),
                   device_parts_ms=parts,
                   plain_device_ms=queued_ms(lambda: l2_topk_ref(q, x, k)),
                   library_device_ms=lib_dev)
        text += (f"; device a call (queued behind a sleep): kernel "
                 f"{out['device_ms']} ms (profiler's parts {json.dumps(parts)}), "
                 f"plain {out['plain_device_ms']} ms, cdist+topk {lib_dev} ms")
    print(f"l2_topk {shape} {text}")
    return out


#: the benchmark cell's three top-k a batch (``random-s-100.b500.np16``: 500
#: queries, ~19.7k lists of up to 44 entries): the probe's select, the
#: merge's top-40 window over 16 lists' padded slots, the final top-10
BENCH_TOPK = {"select": (500, 19_700, 16), "window": (500, 704, 40),
              "final": (500, 40, 10)}
FLUSH_BYTES = 256 << 20          # five times the H100's 50 MB L2


def captured_topk(search) -> list:
    """``(stage, rows, k)`` of each top-k that one call of ``search`` makes
    in ``device_search_batch`` (the probe's select, the merge's window and
    final top-k), the rows copied as they were."""
    from repro_torch.core import cluster_index
    calls, orig = [], cluster_index.topk_smallest

    def keep(d, k):
        calls.append((d.clone(), k))
        return orig(d, k)
    cluster_index.topk_smallest = keep
    try:
        search()
    finally:
        cluster_index.topk_smallest = orig
    require(len(calls) == 3, f"a search batch made {len(calls)} top-k calls, not 3")
    return [(stage, d, k) for stage, (d, k) in zip(BENCH_TOPK, calls)]


def bench_topk_rows(stage: str, R: int, N: int, g) -> torch.Tensor:
    """Rows like the benchmark cell's at a stage: the probe's distances,
    a few near centroids among far ones; the window's, three quarters
    ``inf`` padding; the final top-10's, finite."""
    d = 300 * torch.rand((R, N), device="cuda", generator=g)
    if stage == "select":
        far = 2800 + 1700 * torch.rand((R, N), device="cuda", generator=g)
        near = torch.rand((R, N), device="cuda", generator=g) < 20 / N
        return torch.where(near, 50 + d / 3, far)
    if stage == "window":
        pad = torch.rand((R, N), device="cuda", generator=g) < 0.75
        return torch.where(pad, torch.inf, d)
    return d


def select_case(label: str, d: torch.Tensor, k: int, peaks, flush) -> dict:
    """``topk_select`` against the plain stable sort on one matrix: the same
    bits, values and indices; a call's time in a loop; the kernel's device
    time (profiler) with the matrix in L2, as the search reads it just
    after writing it, and with L2 flushed before each call; the bound, the
    matrix read once and the result written once at HBM's rate, to which
    only the flushed time is held."""
    from repro_torch.kernels import ops, topk_select
    from repro_torch.kernels.ref import stable_topk_smallest

    R, N = d.shape
    shape = f"{R}x{N} k={k} ({label})"
    gv, gi = ops.topk_smallest(d, k)
    wv, wi = stable_topk_smallest(d, k)
    require(torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32)),
            f"topk_select at {shape}: not the stable sort's bits")
    p = topk_select.plan(N, k)
    staged = p.cap < N <= topk_select.max_staged(N, k, d.device.index)
    match = lambda key: "topk_select_kernel" in key  # noqa: E731

    def cold():
        flush.zero_()
        ops.topk_smallest(d, k)
    b_ms = (4 * R * N + 12 * R * k) / peaks[1] * 1e3
    out = {"shape": shape, "infs": int(torch.isinf(d).sum()),
           "plan": (f"{p.threads} threads, {p.digit_bits}-bit digits, {p.cap} "
                    f"candidates, {'staged' if staged else 'read from memory'}"),
           "ms": time_ms(lambda: ops.topk_smallest(d, k), 20),
           "plain_ms": time_ms(lambda: stable_topk_smallest(d, k), 20),
           "device_ms": kernel_device_ms(lambda: ops.topk_smallest(d, k), match)[0],
           "cold_device_ms": kernel_device_ms(cold, match)[0],
           "bound_ms": b_ms, "bound_by": "bytes"}
    require(out["device_ms"] is not None and out["cold_device_ms"] is not None,
            f"topk_select at {shape}: the profiler recorded no topk_select_kernel")
    out["bound_share"] = b_ms / out["cold_device_ms"]
    print(f"topk_select {shape} ({out['plan']}): a loop call {out['ms']:.4f} ms, "
          f"device {out['device_ms']:.4f} ms in L2, {out['cold_device_ms']:.4f} ms "
          f"flushed, bound {b_ms:.6f} ms (bytes at HBM's rate), "
          f"{out['bound_share']:.3f} of it flushed; stable sort {out['plain_ms']:.4f} "
          f"ms; the same bits", flush=True)
    return out


def topk_select_check(captured: dict, dev, peaks) -> dict:
    """The ``kernels`` entry of ``topk_select``: :func:`select_case` on each
    top-k of a search batch at each nprobe (``captured``: nprobe -> the
    three calls) and at :data:`BENCH_TOPK`'s shapes."""
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    cases = [select_case(f"{stage}, nprobe {nprobe}", d, k, peaks, flush)
             for nprobe, calls in captured.items() for stage, d, k in calls]
    g = torch.Generator(device="cuda").manual_seed(0)
    cases += [select_case(f"{stage}, benchmark cell", bench_topk_rows(stage, R, N, g),
                        k, peaks, flush)
              for stage, (R, N, k) in BENCH_TOPK.items()]
    del flush, captured
    torch.cuda.empty_cache()
    main = cases[0]
    return {"name": "topk_select", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_select.cu",
            "replaces": "none (the reference's top-k is jax.lax.top_k, XLA's)",
            "shape": main["shape"], "plan": main["plan"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "device_ms": main["device_ms"],
            "cold_device_ms": main["cold_device_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "bound_share": main["bound_share"],
            "library": "none: torch.topk's tie order is unspecified",
            "cases": cases,
            "checked": "values and int64 indices the plain stable sort's bits "
                       "at every shape"}


def norm_tol(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    qf, xf = q.float(), x.float()
    return TOL * ((qf * qf).sum(-1)[:, None] + (xf * xf).sum(-1)[None, :]) + 1e-6


def near_tie_rows(got_ids, want_ids, q, x, tol_row) -> tuple[int, bool]:
    """Rows whose id lists differ, and whether every such row is a near-tie:
    the exact (float64) distances of the two lists, each sorted, agree
    within the row's f32 tolerance at every rank."""
    diff = (got_ids != want_ids).any(1).nonzero()[:, 0]
    if len(diff) == 0:
        return 0, True
    qd, xd = q[diff].double(), x.double()

    def exact(ids):
        sel = xd[ids[diff].clamp_min(0).long()]                 # (r, k, D)
        return ((sel - qd[:, None, :]) ** 2).sum(-1).sort(-1).values

    gap = (exact(got_ids) - exact(want_ids)).abs()
    return len(diff), bool((gap <= 2 * tol_row[diff][:, None]).all())


def flip_at_boundary(xp, li: int, cents64, cn64, thresh: float, r: int) -> bool:
    """Whether closure pair (point ``xp``, list ``li``), kept on one side and
    not the other, lies within f32 rounding (float64 distances) of the
    ``thresh`` x nearest threshold or of the rank-``r`` boundary."""
    d64 = cn64 - 2.0 * (cents64 @ xp) + (xp * xp).sum()
    srt = d64.sort().values
    tol_p = TOL * ((xp * xp).sum() + cn64.max()).item()
    at_thresh = abs(d64[li].item() - thresh * srt[0].item()) <= 2 * tol_p
    at_rank_r = abs(d64[li].item() - srt[r - 1].item()) <= 2 * tol_p
    return at_thresh or at_rank_r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--graph-n", type=int, default=100_000)
    ap.add_argument("--graph-queries", type=int, default=2_000)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.cluster_index import (ClusterIndex, closure_pairs,
                                                device_search_batch)
    from repro_torch.core.flat import exact_topk
    from repro_torch.core.types import ClusterIndexParams, recall_at_k
    from repro_torch.data.synth import DEEP_ANALOG, make_dataset, scaled
    from repro_torch.exec import batched_topk, scan_topk_oracle
    from repro_torch.hw import card_peaks, smi_line
    from repro_torch.kernels import _build, distance, fused_topk
    from repro_torch.kernels.ref import (full_f32_matmul, l2_distance_ref,
                                         l2_topk_ref)

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    smi = smi_line(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}",
          flush=True)
    report: dict = {"card": smi, "n": args.n, "queries": args.queries,
                    "graph_n": args.graph_n,
                    "graph_queries": args.graph_queries}

    # ---- 1. kernels, built from this checkout --------------------------
    t = t_first = time.perf_counter()
    for src, log in _build.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")
    report["kernel_build_s"] = time.perf_counter() - t
    t = phase("build kernels", t)

    # ---- 2. cluster path: data, index, ground truth, search -----------
    data, queries = make_dataset(scaled(DEEP_ANALOG, args.n, args.queries))
    t = phase("make data", t)

    launches = {}
    params = ClusterIndexParams(kmeans_iters=4, seed=0)
    reset()
    index = ClusterIndex.build(data, params, device=dev)
    torch.cuda.synchronize()
    launches["build"] = counts()
    report["build_s"] = time.perf_counter() - t
    t = phase("index build (host BKT + closure on the card)", t)
    require(launches["build"]["l2_topk"] == math.ceil(args.n / 4096),
            f"closure replication launched l2_topk {launches['build']}")

    arrs = index.device_arrays()
    dv = {key: torch.from_numpy(v).to(dev) for key, v in arrs.items()}
    torch.cuda.synchronize()
    L, ml, D = dv["list_vecs"].shape
    entries = int(arrs["list_len"].sum())
    dev_bytes = sum(v.numel() * v.element_size() for v in dv.values())
    report["index"] = {"lists": L, "entries": entries, "max_len": ml,
                       "replication": entries / args.n,
                       "device_bytes": dev_bytes}
    print(f"index: {L} lists, {entries} entries ({entries / args.n:.3f}x), "
          f"max list {ml}, device_arrays {dev_bytes} bytes on {dv['list_vecs'].device}")
    t = phase("device arrays", t)

    reset()
    gt, _ = exact_topk(data, queries, K, device=dev)
    launches["ground_truth"] = counts()
    t = phase("ground truth (exact_topk)", t)
    require(launches["ground_truth"]["l2_topk"] == math.ceil(args.queries / 512),
            f"exact_topk launched {launches['ground_truth']}")

    qt = torch.from_numpy(queries).to(dev)

    def search(nprobe, lo, hi):
        return device_search_batch(dv["centroids"], dv["list_vecs"],
                                   dv["list_ids"], qt[lo:hi],
                                   nprobe=nprobe, k=K)

    search(NPROBES[0], 0, BATCH)             # warm-up: cuBLAS set-up
    report["search"] = {}
    for nprobe in NPROBES:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [search(nprobe, s, s + BATCH)
                for s in range(0, args.queries, BATCH)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[f"search_nprobe{nprobe}"] = counts()
        ids = torch.cat([o[0] for o in outs]).cpu().numpy()
        dists = torch.cat([o[1] for o in outs]).cpu().numpy()
        rec = float(np.mean([recall_at_k(ids[i], gt[i])
                             for i in range(args.queries)]))
        n_batches = math.ceil(args.queries / BATCH)
        require(launches[f"search_nprobe{nprobe}"]["l2_distance"] == n_batches
                and launches[f"search_nprobe{nprobe}"]["topk_select"] == 3 * n_batches,
                f"search launched {counts()}")
        require(ids.shape == (args.queries, K) and ((ids >= -1) & (ids < args.n)).all(),
                "search ids out of range")
        valid = ids >= 0
        require(np.isfinite(dists[valid]).all() and valid.all(axis=1).all(),
                "search returned fewer than k finite results")
        require(all(len(set(r)) == K for r in ids), "duplicate ids in a result row")
        report["search"][nprobe] = {"recall@10": rec, "qps": args.queries / dt,
                                    "seconds": dt}
        print(f"search nprobe={nprobe}: recall@10 {rec:.4f}, "
              f"{args.queries / dt:.1f} queries/s ({dt:.3f} s)")
        t = phase(f"search nprobe={nprobe}", t)
    rec = [report["search"][p]["recall@10"] for p in NPROBES]
    require(rec[-1] >= rec[0] and rec[-1] >= 0.5, f"recall {rec}")
    report["launches"] = launches
    print("launches on the main path: " + json.dumps(launches))

    # where one search batch's device time goes: kernels by self device
    # time, and the share of the batch's wall time the card sat idle
    report["search_profile"] = {}
    for nprobe in NPROBES:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search(nprobe, 0, BATCH)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in kern)
        top = [(e.key[:60], round(e.self_device_time_total, 1)) for e in kern[:8]]
        report["search_profile"][nprobe] = {
            "wall_us": wall_us, "device_busy_us": busy_us, "top_kernels_us": top}
        print(f"profile nprobe={nprobe}, one batch of {BATCH}: wall {wall_us:.0f} us, "
              f"device busy {busy_us:.0f} us (idle share "
              f"{1 - busy_us / wall_us:.3f}); top kernels (us): {top}")
    t = phase("profile one search batch per nprobe", t)

    # the selection kernel on the rows a search batch gave it, and at the
    # benchmark cell's shapes
    kernels = [topk_select_check(
        {nprobe: captured_topk(lambda: search(nprobe, 0, BATCH)) for nprobe in NPROBES},
        dev, peaks)]
    t = phase("check topk_select", t)

    # the card's answers against the plain path on the CPU, same arrays
    cpu_ids, _ = device_search_batch(
        *(torch.from_numpy(arrs[key]) for key in ("centroids", "list_vecs",
                                                  "list_ids")),
        torch.from_numpy(queries[:64]), nprobe=16, k=K)
    card_ids = search(16, 0, 64)[0].cpu()
    overlap = np.mean([len(np.intersect1d(card_ids[i], cpu_ids[i])) / K
                       for i in range(64)])
    same_rows = int((card_ids == cpu_ids).all(1).sum())
    print(f"card vs CPU plain path, 64 queries at nprobe 16: {same_rows} rows "
          f"identical, mean overlap {overlap:.4f}")
    require(overlap >= 0.99, "card search disagrees with the CPU plain path")
    t = phase("card vs CPU search", t)

    # ---- 2b. the sharded search and k-means steps, one NCCL rank --------
    sharded(dev, data, queries, arrs, dv, report, launches)
    t = phase("sharded search and k-means steps (one NCCL rank)", t)

    # ---- 3. graph path ---------------------------------------------------
    gindex, gdata, gqueries, ggt, gids, gadc, t = graph_path(
        args, dev, report, launches, t)

    # ---- 4. kernels against their plain versions, main-path shapes ----
    cents = dv["centroids"]
    del dv["list_vecs"]
    torch.cuda.empty_cache()

    # l2_distance at the probe: 512 queries x L centroids
    qp = qt[:BATCH]
    tol = norm_tol(qp, cents)
    got = distance.l2_distance(qp, cents)
    want = l2_distance_ref(qp, cents)
    err32 = (got - want).abs()
    dist_err = float(err32.max())
    require(bool((err32 <= tol).all()), f"l2_distance f32 err {dist_err}")
    qb, cb = qp.bfloat16(), cents.bfloat16()
    errbf = (distance.l2_distance(qb, cb) - l2_distance_ref(qb, cb)).abs()
    require(bool((errbf <= norm_tol(qb, cb)).all()),
            f"l2_distance bf16 err {errbf.max().item()}")
    scale = 127.0 / max(qp.abs().max().item(), cents.abs().max().item())
    qi = (qp * scale).round().clamp(-127, 127).to(torch.int8)
    ci = (cents * scale).round().clamp(-127, 127).to(torch.int8)
    require(torch.equal(distance.l2_distance(qi, ci), l2_distance_ref(qi, ci)),
            "l2_distance int8 not exact")
    # the plan at the probe, and the simple instantiation on the same
    # inputs: the same f32 bits (the A/B holds both to the earlier kernel's)
    dplan = distance.plan(BATCH, L, D, torch.cuda.current_device())
    require(dplan.variant is distance.WIDE,
            f"the probe planned {dplan.variant.name}, not the wide kernel")
    require(torch.equal(distance.l2_distance(qp, cents, variant="simple"), got),
            "l2_distance: the wide and simple instantiations' bits differ at the probe")
    del got, want, err32, errbf
    with full_f32_matmul():   # the yardstick in full f32, as the kernels
        lib_ms = time_ms(lambda: torch.cdist(
            qp, cents, compute_mode="use_mm_for_euclid_dist"), 10)
        sgemm_ms = time_ms(lambda: torch.mm(qp, cents.T), 20)
    k_ms = time_ms(lambda: distance.l2_distance(qp, cents), 20)
    simple_ms = time_ms(lambda: distance.l2_distance(qp, cents, variant="simple"), 20)
    p_ms = time_ms(lambda: l2_distance_ref(qp, cents), 10)
    dev_ms, _ = kernel_device_ms(lambda: distance.l2_distance(qp, cents),
                                 lambda key: "l2_distance_wide_kernel" in key)
    b_ms, b_by = l2_bound_ms(BATCH, L, D, 4 * BATCH * L, peaks)
    plan_txt = (f"{dplan.variant.name} {dplan.variant.block_q}x"
                f"{dplan.variant.block_n}, {dplan.ranges} ranges of {dplan.span} rows")
    kernels.append({
        "name": "l2_distance", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l2_distance.cu",
        "replaces": "src/repro/kernels/distance.py:65",
        "max_abs_err": dist_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "library": "torch.cdist(use_mm_for_euclid_dist): root of the same matrix",
        "shape": f"{BATCH}x{L}x{D} f32 (centroid probe)", "plan": plan_txt,
        "bound_share": b_ms / k_ms, "simple_ms": simple_ms,
        "device_ms": dev_ms, "sgemm_ms": sgemm_ms,
        "sgemm": "context only: the product alone, not the same function "
                 "(torch.mm(q, x.T) in full f32)",
        "checked": "f32 and bf16 within 1e-5*(|q|^2+|x|^2); int8 exact; "
                   "wide and simple give identical f32 bits"})
    print(f"l2_distance {BATCH}x{L}x{D} ({plan_txt}): kernel {k_ms:.4f} ms, "
          f"{b_ms / k_ms:.3f} of the bound; device {dev_ms} ms (profiler); simple "
          f"{simple_ms:.4f} ms; plain {p_ms:.4f} ms, cdist "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); sgemm {sgemm_ms:.4f} "
          f"ms (context only: the product alone, not the same function); "
          f"wide and simple bits identical")
    t = phase("check l2_distance", t)

    # l2_topk at the closure step: 4096 points x L centroids, k = r
    r = min(params.num_replica, L)
    pts = torch.from_numpy(data[:4096].astype(np.float32)).to(dev)
    closure_case = topk_case("closure step", pts, cents, r, peaks,
                             reps=(10, 3))

    # closure pairs: kernel vs plain through the build's own rule, on every
    # stride-th chunk of the build's 4096-point chunks
    thresh = (1.0 + params.closure_eps) ** 2
    cents64 = cents.double()
    cn64 = (cents64 * cents64).sum(-1)
    stride = max(1, math.ceil(args.n / 4096 / 32))
    n_pairs = n_flip = n_pts = 0
    for s in range(0, args.n, 4096 * stride):
        xc = torch.from_numpy(data[s:s + 4096].astype(np.float32)).to(dev)
        sides = []
        for fn in (fused_topk.l2_topk, l2_topk_ref):
            dd, ii = fn(xc, cents, r)
            lists, points = closure_pairs(dd.cpu().numpy(), ii.cpu().numpy(),
                                          thresh, s)
            sides.append(set((points * L + lists).tolist()))
        n_pts += len(xc)
        n_pairs += len(sides[0])
        for code in sides[0] ^ sides[1]:
            p, li = divmod(code, L)
            xp = torch.from_numpy(data[p].astype(np.float64)).to(dev)
            require(flip_at_boundary(xp, li, cents64, cn64, thresh, r),
                    f"closure pair (point {p}, list {li}) flipped away from "
                    f"the threshold and the rank-{r} boundary")
            n_flip += 1
    print(f"closure: {n_pts} points, {n_pairs} pairs, {n_flip} flipped pairs, "
          f"all at the (1+eps)^2 threshold or the rank-{r} boundary")
    report["closure_check"] = {"points": n_pts, "pairs": n_pairs,
                               "flipped": n_flip}
    t = phase("check closure", t)

    # l2_topk at the ground truth: 512 queries x N points, k=10; ids of
    # exact_topk on 1,024 queries against the plain version
    xs = torch.from_numpy(data).to(dev)
    cases = [topk_case("exact_topk", qt[s:s + 512], xs, K, peaks,
                       reps=(0, 0) if s else (5, 2))
             for s in range(0, min(1024, args.queries), 512)]
    gt_case = cases[0]
    topk_err = max(c["max_abs_err"] for c in (closure_case, *cases))
    print(f"exact_topk: {sum(c['rows_differing'] for c in cases)} of "
          f"{512 * len(cases)} rows differ, all near-ties")
    kernels.append({
        "name": "l2_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_topk.cu",
        "replaces": "src/repro/kernels/fused_topk.py:64",
        "max_abs_err": topk_err, "ms": closure_case["ms"],
        "plain_ms": closure_case["plain_ms"], "bound_ms": closure_case["bound_ms"],
        "bound_by": closure_case["bound_by"], "library_ms": closure_case["library_ms"],
        "library": "two calls, context only: torch.cdist(use_mm_for_euclid_dist)"
                   " squared, then torch.topk, in full f32",
        "shape": closure_case["shape"], "bound_share": closure_case["bound_share"],
        "plan": closure_case["plan"],
        "gt_shape": gt_case["shape"], "gt_ms": gt_case["ms"],
        "gt_plain_ms": gt_case["plain_ms"], "gt_bound_ms": gt_case["bound_ms"],
        "gt_library_ms": gt_case["library_ms"],
        "gt_bound_share": gt_case["bound_share"],
        "gt_plan": gt_case["plan"],
        "checked": "values within 1e-5*(|q|^2+|x|^2); ids equal up to near-ties"})
    t = phase("check exact_topk", t)

    # batched_topk (coalesced scans) against the per-query oracle: random
    # rows (ids equal up to near-ties: the card and the CPU sum in other
    # orders), then integer-valued rows with exact ties (bit-exact)
    rng = np.random.default_rng(0)
    for b in (1, 5, 8, 9, 33, 200):
        qb_ = rng.standard_normal((b, 32)).astype(np.float32)
        xb_ = rng.standard_normal((3000, 32)).astype(np.float32)
        vk, ik = batched_topk(qb_, xb_, K, device=dev)
        vo, io = scan_topk_oracle(qb_, xb_, K)
        require(np.allclose(vk, vo, rtol=1e-5, atol=1e-5), f"batched_topk vals, batch {b}")
        for row in np.flatnonzero((ik != io).any(1)):
            exact = [np.sort(((xb_[ids].astype(np.float64) - qb_[row]) ** 2).sum(-1))
                     for ids in (ik[row], io[row])]
            require(np.allclose(exact[0], exact[1], rtol=1e-5, atol=0),
                    f"batched_topk ids differ beyond a near-tie, batch {b}")
    qi_ = rng.integers(-8, 8, (9, 32)).astype(np.float32)
    xi_ = rng.integers(-8, 8, (500, 32)).astype(np.float32)
    xi_ = np.concatenate([xi_, xi_[:200]])
    vk, ik = batched_topk(qi_, xi_, 50, device=dev)
    vo, io = scan_topk_oracle(qi_, xi_, 50)
    require(np.array_equal(ik, io) and np.array_equal(vk, vo),
            "batched_topk not bit-exact on integer inputs with ties")
    t = phase("check batched_topk", t)

    kernels.append(adc_check(gindex, gqueries, dev, peaks, report))
    t = phase("check adc_lookup", t)

    # ---- 5. calibration harness ----------------------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    table_path = (args.out.with_name(args.out.stem + ".calibration.json")
                  if args.out is not None else Path(tmp.name) / "calibration.json")
    calibration(dev, report, table_path)
    t = phase("calibration (measure_table)", t)

    # ---- 6. the serving fleet over both indexes ------------------------
    from repro_torch.core.types import SearchParams
    nf = min(FLEET_QUERIES, args.queries)
    sp = SearchParams(k=K, nprobe=NPROBES[0])
    rep = crep = serve_fleet("cluster", index, queries[:nf], sp, gt[:nf],
                             table_path, report, launches)
    # the fleet's ids against index.search on the first 64 queries. Both
    # rank by a stable sort of f32 distances, so ids whose f32 distances are
    # equal keep their position order: the fleet's merge lists the shards'
    # top-ks shard by shard, the single scan its posting lists in probe
    # order, and such a tie may come out the other way round. A row may
    # differ only where (a) both sides hold the same ids, each in its own
    # f32 order, and (b) every pair the two order differently is such a
    # tie (equal f32 distances on both sides) or follows its values, each
    # value within f32 of its float64 distance and the pair's float64
    # distances within f32 of each other
    hits = [index.search(queries[i], sp) for i in range(64)]
    direct = np.stack([h.ids for h in hits])
    direct_d = np.stack([h.dists for h in hits])
    by_qid = {r.qid: r for r in rep.records}
    fleet_ids = np.stack([by_qid[i].ids for i in range(64)])
    fleet_d = np.stack([by_qid[i].dists for i in range(64)])
    q64 = qt[:64]
    tol64 = TOL * ((q64 * q64).sum(-1) + (xs * xs).sum(-1).max()) + 1e-6
    n_diff, ties = near_tie_rows(torch.from_numpy(fleet_ids).to(dev),
                                 torch.from_numpy(direct).to(dev), q64, xs, tol64)
    sorted_ok = all(bool((d[:, 1:] >= d[:, :-1]).all()) for d in (fleet_d, direct_d))
    same_f32 = int((np.sort(fleet_d, 1) == np.sort(direct_d, 1)).all(1).sum())
    differ = np.flatnonzero((fleet_ids != direct).any(1))
    same_ids = all(set(fleet_ids[i].tolist()) == set(direct[i].tolist()) for i in differ)
    swaps = []
    for i in differ:
        fd = dict(zip(fleet_ids[i].tolist(), fleet_d[i].tolist()))
        sd = dict(zip(direct[i].tolist(), direct_d[i].tolist()))
        fr = {v: r for r, v in enumerate(fleet_ids[i].tolist())}
        sr = {v: r for r, v in enumerate(direct[i].tolist())}
        both = sorted(fr.keys() & sr.keys(), key=fr.get)
        for a_pos, a in enumerate(both):
            for b in both[a_pos + 1:]:
                if sr[a] > sr[b]:
                    exact = ((xs[[a, b]].double() - qt[i].double()) ** 2).sum(-1).tolist()
                    tol = float(tol64[i])
                    swaps.append({
                        "query": int(i), "ids": [a, b],
                        "fleet_ranks": [fr[a], fr[b]], "search_ranks": [sr[a], sr[b]],
                        "fleet_f32": [fd[a], fd[b]], "search_f32": [sd[a], sd[b]],
                        "f64": exact, "tol": tol,
                        "kind": ("f32 tie" if fd[a] == fd[b] and sd[a] == sd[b]
                                 else "f32 values"),
                        "explained": (abs(exact[0] - exact[1]) <= 2 * tol and all(
                            abs(v - e) <= tol for side in (fd, sd)
                            for v, e in zip((side[a], side[b]), exact)))})
    report["fleet"]["cluster"]["rows_differing_from_search"] = n_diff
    report["fleet"]["cluster"]["rows_with_the_same_f32_distances"] = same_f32
    report["fleet"]["cluster"]["swaps"] = swaps
    for i in differ[:8]:
        print(f"fleet cluster vs index.search, query {i}: fleet {fleet_ids[i]} "
              f"search {direct[i]}")
    for s in swaps[:8]:
        print(f"fleet cluster swap ({s['kind']}), query {s['query']}, ids {s['ids']}: "
              f"fleet ranks {s['fleet_ranks']} f32 {s['fleet_f32'][0]!r} "
              f"{s['fleet_f32'][1]!r}; search ranks {s['search_ranks']} f32 "
              f"{s['search_f32'][0]!r} {s['search_f32'][1]!r}; float64 "
              f"{s['f64'][0]!r} {s['f64'][1]!r}; f32 tolerance {s['tol']!r}")
    print(f"fleet cluster vs index.search, 64 queries: {64 - n_diff} rows "
          f"identical, {n_diff} differ, all near-ties: {ties}, same ids: {same_ids}, "
          f"swaps within f32 of float64: {all(s['explained'] for s in swaps)}; "
          f"{same_f32} rows with the same f32 distances")
    require(sorted_ok, "fleet or index.search rows not in their f32 distance order")
    require(same_ids, "fleet (cluster) rows hold other ids than index.search's")
    require(all(s["explained"] for s in swaps),
            "fleet ids swapped against index.search beyond f32 rounding")
    require(ties, f"fleet (cluster) ids differ from index.search beyond "
            f"near-ties in {n_diff} of the first 64 queries")
    t = phase("fleet: cluster index, 4 shards x 2 replicas", t)

    ng = min(GRAPH_FLEET_QUERIES, args.graph_queries)
    sp = SearchParams(k=K, search_len=SEARCH_LENS[0], beamwidth=BEAMWIDTH)
    rep = serve_fleet("graph", gindex, gqueries[:ng], sp, ggt[:ng], table_path,
                      report, launches)
    # one lookup for each query's medoid and one for each round that found
    # new neighbours: the graph path's own count on these queries, and at
    # most queries + round trips
    f = report["fleet"]["graph"]
    n_adc, rts = f["launches"]["adc_lookup"], f["roundtrips"]
    f["rounds_without_new_neighbours"] = ng + rts - n_adc
    print(f"fleet graph: {n_adc} adc_lookup launches = {ng} queries + {rts} "
          f"round trips - {ng + rts - n_adc} rounds without new neighbours; "
          f"the graph path launched {gadc[ng - 1]} on these queries")
    require(n_adc == gadc[ng - 1] and rts <= n_adc <= ng + rts,
            f"graph fleet: {n_adc} adc_lookup launches for {ng} queries and "
            f"{rts} round trips; the graph path launched {gadc[ng - 1]}")
    require(all(np.array_equal(r.ids, gids[r.qid]) for r in rep.records)
            and len(rep.records) == ng,
            f"graph fleet ids differ from the graph path's search at "
            f"search_len {SEARCH_LENS[0]}")
    direct_rec = float(np.mean([recall_at_k(gids[r.qid], ggt[r.qid])
                                for r in rep.records]))
    require(f["recall@10"] == direct_rec,
            f"graph fleet recall {f['recall@10']} vs the direct search's {direct_rec}")
    t = phase("fleet: graph index, 4 shards x 2 replicas", t)

    # ---- 7. multi-tenancy: both indexes as tenants of one fleet --------
    tenancy(index, queries[:nf], gt[:nf], crep, gindex, gqueries[:ng],
            ggt[:ng], rep, np.diff(np.asarray([0] + list(gadc))), table_path,
            report, launches)
    t = phase("tenancy: 2 tenants over one fleet, weighted cache, and solo", t)

    # ---- 8-9. the write path (mutates the indexes' stores: last) -------
    write_path("cluster", index, data, queries[:nf],
               SearchParams(k=K, nprobe=NPROBES[0]), None, table_path, dev,
               report, launches)
    t = phase("write path: cluster index", t)
    write_path("graph", gindex, gdata, gqueries[:ng], sp,
               frozenset([gindex.meta.medoid]), table_path, dev, report,
               launches)
    t = phase("write path: graph index", t)
    tmp.cleanup()

    # ---- 10. the fleet CLI on the card ---------------------------------
    fleet_cli(report)
    t = phase("fleet CLI on the card", t)

    # ---- 11. the auto-tuner --------------------------------------------
    tuner_kernels(dev, peaks, kernels, report)
    t = phase("tuner: kernels at the tuner's shapes", t)
    tuner(report, launches)
    t = phase("tuner CLI", t)

    # ---- 12. retrieval-augmented generation at gemma-2b's full width ----
    from repro_torch.configs.archs import ARCHS
    gemma = ARCHS["gemma-2b"]
    params = rag(dev, peaks, kernels, report, launches, gemma, RAG_CORPUS)
    t = phase("RAG at gemma-2b's full width", t)

    # ---- 13. training at gemma-2b's full width -------------------------
    first_layer = {k: v.cpu() for k, v in params.items()
                   if not k.startswith("blocks.") or k.startswith("blocks.0.")}
    train_full(peaks, report, launches, gemma, params)
    t = phase("training at gemma-2b's full width", t)
    train_one_layer(dev, report, gemma, first_layer)
    t = phase("training: one layer at gemma-2b's widths, card vs CPU", t)
    train_smoke(dev, report, launches)
    t = phase("training: smoke config, preemption and resume", t)

    # ---- 14. training through DTensors, and the dry-run -----------------
    train_dtensor(dev, report, launches)
    t = phase("training through DTensors on a 1x1 mesh (one NCCL rank)", t)
    clis(report)
    t = phase("serve CLI and train CLI on the card, and the dry-run's 3 "
              "cells on a fake 256-rank world, at once", t)

    # ---- 15. the examples on the card ------------------------------------
    examples(dev, peaks, report, launches)
    t = phase("examples: quickstart, cloud_tuning, rag_serving (card and "
              "CPU), train_lm at 100M", t)
    report["phases_s"] = t - t_first
    print(f"phases: {report['phases_s']:.3f} s in all", flush=True)

    for kern in kernels:
        kern["launches"] = sum(c[kern["name"]] for c in launches.values())
    report["launches"] = launches
    print("launches on the main paths: " + json.dumps(launches))
    report["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def _timed(fn, spent: dict, key: str):
    """``fn``, adding its wall time to ``spent[key]`` on every call."""
    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[key] += time.perf_counter() - t0
    return timed


def graph_path(args, dev, report, launches, t):
    """Build the graph index on the card, take its ground truth and search
    it at each search_len; returns (index, data, queries, ground truth, the
    ids of the search at the first search_len, the adc_lookup launches of
    that search after each query, phase clock)."""
    from repro_torch.convert import graph_index_from_reference
    from repro_torch.core import graph_index as gi
    from repro_torch.core import pq as pqmod
    from repro_torch.core.flat import exact_topk
    from repro_torch.core.graph_index import GraphIndex
    from repro_torch.core.types import (GraphIndexParams, SearchParams,
                                        recall_at_k)
    from repro_torch.data.synth import DEEP_ANALOG, make_dataset, scaled

    n, nq = args.graph_n, args.graph_queries
    data, queries = make_dataset(scaled(DEEP_ANALOG, n, nq))
    t = phase("graph: make data", t)
    params = GraphIndexParams(R=24, L_build=48, build_passes=1, pq_dims=48,
                              seed=0)
    # where the build's time goes: each piece's wall time, summed over its
    # calls (the greedy search ends in a copy to the host, so it is synced)
    parts = {"greedy_search_card": (gi, "_greedy_search_build"),
             "robust_prune_host": (gi, "_robust_prune"),
             "pq_train_card": (pqmod, "train_pq"),
             "pq_encode_host": (pqmod.ProductQuantizer, "encode")}
    spent = dict.fromkeys(parts, 0.0)
    originals = {key: getattr(*where) for key, where in parts.items()}
    for key, (owner, attr) in parts.items():
        setattr(owner, attr, _timed(originals[key], spent, key))
    reset()
    try:
        index = GraphIndex.build(data, params, device=dev)
        torch.cuda.synchronize()
    finally:
        for key, (owner, attr) in parts.items():
            setattr(owner, attr, originals[key])
    launches["graph_build"] = counts()
    build_s = time.perf_counter() - t
    spent["rest_host"] = build_s - sum(spent.values())
    g = report["graph"] = {"params": str(params), "build_s": build_s,
                           "build_parts_s": spent,
                           "node_nbytes": index.meta.node_nbytes,
                           "search": {}}
    print("graph build parts (s): " + json.dumps(spent))
    t = phase("graph: index build (greedy search and PQ training on the "
              "card, prune on the host)", t)
    adj = index.device_arrays()["adjacency"]
    deg = (adj >= 0).sum(1)
    # one batch of the build's greedy search under the profiler (the final
    # graph, 256 points): how busy the card is in that launch-heavy loop
    data_t = torch.from_numpy(data[:, :]).to(dev)
    adj_t = torch.from_numpy(adj).to(dev)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        originals["greedy_search_card"](data_t, adj_t, data_t[:256],
                                        index.meta.medoid, params.L_build)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    g["greedy_search_profile"] = {"wall_us": wall_us, "device_busy_us": busy_us,
                                  "kernels": sum(e.count for e in kern)}
    print(f"profile of one greedy-search batch of 256: wall {wall_us:.0f} us, "
          f"device busy {busy_us:.0f} us, {sum(e.count for e in kern)} "
          f"kernels")
    del data_t, adj_t
    t = phase("graph: profile one greedy-search batch", t)
    require(deg.max() <= params.R and not (adj == np.arange(n)[:, None]).any(),
            "graph degree above R or a self loop")
    g["mean_degree"] = float(deg.mean())
    print(f"graph: {n} nodes, mean degree {deg.mean():.2f}, node block "
          f"{index.meta.node_nbytes} bytes, codes {index.meta.codes.shape} "
          f"{index.meta.codes.dtype}, a round's codes gathered to {index.device}")

    reset()
    gt, _ = exact_topk(data, queries, K, device=dev)
    launches["graph_ground_truth"] = counts()
    require(launches["graph_ground_truth"]["l2_topk"] == math.ceil(nq / 512),
            f"graph exact_topk launched {launches['graph_ground_truth']}")
    t = phase("graph: ground truth (exact_topk)", t)

    index.search(queries[0], SearchParams(k=K, search_len=SEARCH_LENS[0],
                                          beamwidth=BEAMWIDTH))   # warm-up
    recs, ids_at, adc_after = [], {}, {}
    adc = _kernels()["adc_lookup"]
    for sl in SEARCH_LENS:
        sp = SearchParams(k=K, search_len=sl, beamwidth=BEAMWIDTH)
        adc_s = {"adc": 0.0}      # ids to the card, lookup, distances back
        index._adc = _timed(index._adc, adc_s, "adc")
        reset()
        torch.cuda.synchronize()
        res, after = [], []
        adc_after[sl] = after
        t0 = time.perf_counter()
        for q in queries:
            res.append(index.search(q, sp))
            after.append(adc.launches)    # launches after each query
        dt = time.perf_counter() - t0
        c = launches[f"graph_search_L{sl}"] = counts()
        del index._adc
        ids = ids_at[sl] = np.stack([r.ids for r in res])
        rec = float(np.mean([recall_at_k(ids[i], gt[i]) for i in range(nq)]))
        rts = sum(r.metrics.roundtrips for r in res)
        rows = sum(r.metrics.pq_dist_comps for r in res)
        # one lookup for the medoid, then one per round with new neighbours
        # (a round whose neighbours were all seen before launches none)
        require(rts <= c["adc_lookup"] <= nq + rts,
                f"search_len {sl}: {c['adc_lookup']} adc_lookup launches for "
                f"{rts} round trips of {nq} queries")
        require(((ids >= 0) & (ids < n)).all(), "graph search ids out of range")
        require(all(len(set(r)) == K for r in ids),
                "duplicate ids in a graph result row")
        recs.append(rec)
        g["search"][sl] = {"recall@10": rec, "qps": nq / dt, "seconds": dt,
                           "roundtrips_per_query": rts / nq,
                           "adc_rows_per_query": rows / nq,
                           "adc_launches": c["adc_lookup"],
                           "adc_share": adc_s["adc"] / dt}
        print(f"graph search_len={sl} W={BEAMWIDTH}: recall@10 {rec:.4f}, "
              f"{nq / dt:.1f} queries/s ({dt:.3f} s), {rts / nq:.2f} round "
              f"trips and {rows / nq:.1f} ADC rows per query, "
              f"{c['adc_lookup']} adc_lookup launches, "
              f"{adc_s['adc'] / dt:.3f} of the time in the ADC calls")
        t = phase(f"graph: search search_len={sl}", t)
    require(recs[-1] >= recs[0] and recs[-1] >= 0.5, f"graph recall {recs}")

    # the card's search against the plain path on the CPU, same index
    cpu_index = graph_index_from_reference(index, device="cpu")
    sp = SearchParams(k=K, search_len=SEARCH_LENS[0], beamwidth=BEAMWIDTH)
    over, same = [], 0
    for q in queries[:64]:
        a, b = index.search(q, sp).ids, cpu_index.search(q, sp).ids
        over.append(len(np.intersect1d(a, b)) / K)
        same += int(np.array_equal(a, b))
    g["card_vs_cpu"] = {"rows_identical": same, "overlap": float(np.mean(over))}
    print(f"graph card vs CPU plain path, 64 queries at search_len "
          f"{SEARCH_LENS[0]}: {same} rows identical, mean overlap "
          f"{np.mean(over):.4f}")
    require(np.mean(over) >= 0.99, "graph search on the card disagrees with "
            "the CPU plain path")
    t = phase("graph: card vs CPU search", t)
    return (index, data, queries, gt, ids_at[SEARCH_LENS[0]],
            adc_after[SEARCH_LENS[0]], t)


def adc_paths(codes, tab, got, label) -> dict:
    """Both ``adc_lookup`` paths on the same inputs: the same bits as
    ``got`` (required), each kernel's device time and a CUDA graph's time
    a call."""
    from repro_torch.kernels import pq_adc
    names = {"staged": lambda key: "adc_kernel" in key,
             "direct": lambda key: "adc_direct_kernel" in key}
    out = {}
    for path in pq_adc.PATHS:
        require(torch.equal(pq_adc.adc_lookup(codes, tab, path=path), got),
                f"adc_lookup {label}: the {path} path's bits differ")
        fn = lambda: pq_adc.adc_lookup(codes, tab, path=path)  # noqa: E731
        dev_ms, n = kernel_device_ms(fn, names[path])
        out[path] = {"device_ms": dev_ms, "recorded": n,
                     "graph_ms": graph_ms(fn, 200)}
    return out


def adc_paths_text(r: dict) -> str:
    dev = (f"{r['device_ms']:.6f} ms on the card ({r['recorded']} kernels "
           f"recorded)" if r["device_ms"] else "not captured")
    return f"{dev}, {r['graph_ms']:.6f} ms a call in a CUDA graph"


def adc_case(label, codes, tab, reps, plain_reps, dev, peaks) -> dict:
    """``adc_lookup`` against its plain version on one shape (int32 codes
    must give the uint8 bits); times the call in a loop, both paths' kernels,
    the plain version and ``embedding_bag``."""
    import torch.nn.functional as F

    from repro_torch.kernels import pq_adc
    from repro_torch.kernels.ref import adc_lookup_ref

    N, m = codes.shape
    got = pq_adc.adc_lookup(codes, tab)
    want = adc_lookup_ref(codes, tab)
    diff = (got - want).abs()
    require(bool((diff <= ADC_ATOL + ADC_RTOL * want.abs()).all()),
            f"adc_lookup {label} {N}x{m}: max abs err {diff.max().item()}")
    require(torch.equal(pq_adc.adc_lookup(codes.int(), tab), got),
            f"adc_lookup {label}: int32 codes differ from uint8")
    offs = codes.long() + 256 * torch.arange(m, device=dev)[None, :]
    flat = tab.reshape(-1, 1)
    lib = F.embedding_bag(offs, flat, mode="sum")[:, 0]
    require(bool(((lib - want).abs() <= ADC_ATOL + ADC_RTOL * want.abs()).all()),
            f"embedding_bag disagrees with the plain version ({label})")
    lib_ms = time_ms(lambda: F.embedding_bag(offs, flat, mode="sum"), reps)
    k_ms = time_ms(lambda: pq_adc.adc_lookup(codes, tab), reps)
    p_ms = time_ms(lambda: adc_lookup_ref(codes, tab), plain_reps)
    b_ms = (N * m + 4 * N + 4 * m * 256) / peaks[1] * 1e3
    # a loop of launches runs at the wrapper's host rate when the kernel
    # is shorter than that; the profiler gives each path's kernel time,
    # a CUDA graph of 200 calls the time a call without the host
    paths = adc_paths(codes, tab, got, label)
    auto = "direct" if N <= pq_adc.SMALL_N else "staged"
    print(f"adc_lookup {N}x{m} ({label}): kernel {k_ms:.4f} ms a call "
          f"in a loop ({auto} path); "
          + "; ".join(f"{p} {adc_paths_text(r)}" for p, r in paths.items())
          + f"; plain {p_ms:.4f} ms, embedding_bag {lib_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms (bytes), max abs err {float(diff.max()):.3g}")
    return {"shape": f"{N}x{m} ({label})", "ms": k_ms, "path": auto,
            "device_ms": paths[auto]["device_ms"], "paths": paths,
            "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": "bytes", "max_abs_err": float(diff.max())}


def adc_check(index, queries, dev, peaks, report) -> dict:
    """``adc_lookup`` against its plain version at a real search round's
    codes, at the whole code array, and at the GIST shape (m = 120, the
    dynamic shared-memory path); times kernel, plain version and
    ``embedding_bag``."""
    from repro_torch.core.types import SearchParams
    from repro_torch.kernels import pq_adc

    # record the lookups of one query's search; keep its largest round
    pq = index.meta.pq
    seen = []
    pq.adc_lookup_dev = lambda c, tb: (seen.append((c, tb)),
                                       type(pq).adc_lookup_dev(pq, c, tb))[1]
    try:
        index.search(queries[0], SearchParams(k=K, search_len=SEARCH_LENS[0],
                                              beamwidth=BEAMWIDTH))
    finally:
        del pq.adc_lookup_dev
    round_codes, table = max(seen, key=lambda ct: len(ct[0]))
    rng = np.random.default_rng(1)
    codes_all = index.codes_dev
    n_all = codes_all.shape[0]
    gist_codes = torch.from_numpy(
        rng.integers(0, 256, (n_all, 120), dtype=np.uint8)).to(dev)
    gist_table = torch.from_numpy(
        rng.random((120, 256), dtype=np.float32)).to(dev)
    cases = (("search round", round_codes, table, 500, 500),
             ("all codes", codes_all, table, 50, 10),
             ("gist m=120", gist_codes, gist_table, 50, 10))
    shapes = [adc_case(*case, dev, peaks) for case in cases]
    err = max(c["max_abs_err"] for c in shapes)
    # where the direct path stops paying: both paths on the first N rows of
    # the graph's codes with the round's table
    sweep = []
    for N in ADC_SWEEP_N:
        codes = codes_all[:N]
        paths = adc_paths(codes, table, pq_adc.adc_lookup(codes, table),
                          f"{N} rows")
        sweep.append({"n": N, "paths": paths})
        print(f"adc_lookup sweep {N}x{codes.shape[1]}: "
              + "; ".join(f"{p} {adc_paths_text(r)}" for p, r in paths.items()))
    report["adc_sweep"] = sweep
    report["adc_shapes"] = shapes
    first = shapes[0]
    return {
        "name": "adc_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pq_adc.cu",
        "replaces": "src/repro/kernels/pq_adc.py:41",
        "max_abs_err": err, "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": "bytes",
        "library_ms": first["library_ms"],
        "library": "torch.nn.functional.embedding_bag(mode='sum') over "
                   "codes + 256*j into the flattened table",
        "shape": first["shape"], "shapes": shapes,
        "device_ms": first["device_ms"], "path": first["path"],
        "checked": f"rtol {ADC_RTOL} atol {ADC_ATOL} against the plain "
                   f"version; int32 codes equal uint8; the staged and the "
                   f"direct path give identical bits"}


def calibration(dev, report, path: Path) -> None:
    """``measure_table`` on the card: every unit cost positive and every
    dist point under the FP32 roofline; the table is saved at ``path``."""
    from repro_torch.exec import measure_table

    reset()
    table = measure_table(device=dev)
    c = counts()
    n_dist = sum(e.op == "dist" for e in table.entries)
    rl = table.meta["rooflines"]
    require(all(e.unit_s > 0 for e in table.entries), "a unit_s <= 0")
    require(len(rl) == n_dist and all(r["roofline_frac"] < 1.0 for r in rl),
            "a calibration point above the roofline")
    summary = table.describe()
    report["calibration"] = {
        "summary": summary, "launches": c, "meta": table.meta,
        "entries": [e.to_dict() for e in table.entries]}
    print(f"calibration: {json.dumps(summary)}, launches {c}, "
          f"max roofline frac {max(r['roofline_frac'] for r in rl):.4f}")
    for e in table.entries:
        print(f"  {e.op} dim={e.dim} pq_m={e.pq_m} batch={e.batch}: "
              f"{e.us_per_call:.1f} us/call, unit_s {e.unit_s:.3e}")
    path.parent.mkdir(parents=True, exist_ok=True)
    table.save(str(path))


def fleet_config(table_path, **kw):
    """The smoke's fleet: 4 shards x 2 replicas, hedged, ``tos`` storage,
    the kernel backend priced from ``table_path``, seed 0."""
    from repro_torch.fleet import FleetConfig
    from repro_torch.storage.spec import TOS
    return FleetConfig(n_shards=4, replication=2, concurrency=64,
                       shard_concurrency=8, queue_depth=64, hedge=True,
                       storage=TOS, backend="kernel", batch_window_s=200e-6,
                       calibration=str(table_path), seed=0, **kw)


def tenancy(index, queries, gt, crep, gindex, gqueries, ggt, grep, gadc_q,
            table_path, report, launches) -> None:
    """Two tenants share one fleet (``measure_interference``: the shared
    run, then each tenant solo): ``search-hot``, the cluster index under a
    Zipf trace at 500 queries/s, weight 2, SLO 60 ms; ``analytics``, the
    graph index under a burst at 50 queries/s (x10), weight 1, SLO 150 ms;
    the ``weighted`` cache policy at 64 MiB a node.  The tenants wrap the
    read-only indexes (no build).  Each tenant's ids must equal the
    single-tenant fleet's for the same query (``crep``, ``grep``), and the
    graph tenant's ``adc_lookup`` launches its queries' own counts
    (``gadc_q``: the graph path's launches a query) in both runs."""
    from repro_torch.core.types import SearchParams
    from repro_torch.tenancy import Tenant, TenantSpec, measure_interference

    cfg = fleet_config(table_path, cache_bytes=64 << 20, cache_policy="slru")
    specs = (
        TenantSpec(name="search-hot", n=index.meta.n_data, dim=index.meta.dim,
                   index="cluster", n_queries=len(queries), k=K,
                   nprobe=NPROBES[0], scenario="trace", rate_qps=500.0,
                   n_arrivals=len(queries), slo_ms=60, weight=2.0),
        TenantSpec(name="analytics", n=gindex.meta.n_data, dim=gindex.meta.dim,
                   index="graph", n_queries=len(gqueries), k=K,
                   search_len=SEARCH_LENS[0], beamwidth=BEAMWIDTH,
                   scenario="burst", rate_qps=50.0, burst_factor=10.0,
                   n_arrivals=len(gqueries), slo_ms=150, weight=1.0))
    params = (SearchParams(k=K, nprobe=NPROBES[0]),
              SearchParams(k=K, search_len=SEARCH_LENS[0], beamwidth=BEAMWIDTH))

    def make_tenants():
        return [Tenant(spec=sp, index=ix, queries=q, params=pa)
                for sp, ix, q, pa in zip(specs, (index, gindex),
                                         (queries, gqueries), params)]

    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = measure_interference(make_tenants, cfg, "weighted")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = launches["tenancy"] = counts()
    out = report["tenancy"] = {"config": cfg.to_dict(), "policy": "weighted",
                               "wall_s": wall, "launches": c,
                               "reallocations": rep.reallocations,
                               "aggregate_goodput_qps": rep.aggregate_goodput_qps,
                               "tenants": {}}
    for sl, single, truth in zip(rep.tenants, (crep, grep), (gt, ggt)):
        by_qid = {r.qid: r.ids for r in single.records}
        require(len(sl.records) > 0, f"tenant {sl.name} served nothing")
        same = all(np.array_equal(r.ids, by_qid[r.qid]) for r in sl.records)
        rec = sl.recall_against(truth)
        d = out["tenants"][sl.name] = {
            "queries": len(sl.records), "p50_s": sl.latency_percentile(50),
            "p99_s": sl.latency_percentile(99),
            "p99_sojourn_s": sl.sojourn_percentile(99),
            "goodput_qps": sl.goodput_qps, "goodput_frac": sl.goodput_frac,
            "hit_rate": sl.hit_rate, "interference_ratio": sl.interference_ratio,
            "recall@10": rec, "ids_equal_single_tenant": same,
            "cache_quota_bytes": sl.cache_quota_bytes}
        print(f"tenant {sl.name}: {len(sl.records)} queries, p50 "
              f"{d['p50_s'] * 1e3:.3f} ms, p99 {d['p99_s'] * 1e3:.3f} ms, "
              f"goodput {d['goodput_qps']:.2f} queries/s "
              f"({d['goodput_frac']:.4f} within its SLO), hit rate "
              f"{d['hit_rate']:.4f}, interference ratio "
              f"{d['interference_ratio']}, recall@10 {rec:.4f}; ids equal the "
              f"single-tenant fleet's: {same}")
        require(same, f"tenant {sl.name}: ids differ from the single-tenant "
                f"fleet's for the same queries")
    # the solo run replays the tenant's arrival sample, so each of its
    # queries launches again what it launched in the shared run
    g = rep.tenant("analytics")
    want = 2 * int(sum(gadc_q[r.qid] for r in g.records))
    out["adc_lookup_expected"] = want
    print(f"tenancy: {c['adc_lookup']} adc_lookup launches, the graph path's "
          f"count for the graph tenant's queries in the shared and the solo run "
          f"{want}; {c['l2_topk']} l2_topk; {rep.reallocations} quota "
          f"reallocations; aggregate goodput {rep.aggregate_goodput_qps:.2f} "
          f"queries/s; simulation wall {wall:.3f} s")
    require(c["adc_lookup"] == want,
            f"tenancy: {c['adc_lookup']} adc_lookup launches, expected {want}")


def write_path(label, index, data, queries, params, protected, table_path,
               dev, report, launches) -> None:
    """``run_fleet`` with the documented rw stream (400 updates at 400/s,
    a fifth deletes, seed 0; a 64 KiB delta tier a site) on the smoke's
    fleet.  Every update must be applied (its id live or deleted as the
    stream leaves it); the merged search on the first 64 queries must
    return no deleted id; ``churn_ground_truth`` on the card must give the
    plain version's ids on those queries, up to near-ties."""
    from repro_torch.fleet import FleetRouter
    from repro_torch.ingest import (IngestConfig, churn_ground_truth,
                                    churned_corpus, synth_updates)

    stream = synth_updates(data, rate_qps=400.0, n_updates=400,
                           delete_frac=0.2, seed=0, protected=protected)
    cfg = fleet_config(table_path)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router = FleetRouter(index, cfg)
    rep = router.run(queries, params, updates=stream,
                     ingest=IngestConfig(delta_cap_bytes=64 * 1024))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ctx = router.ctxs[0]
    mut, ing = ctx.index, ctx.ingest_report
    # the state each id ends in, by its last op
    last = {op.id: op.kind for op in stream.ops}
    live = [i for i, k in last.items() if k == "insert"]
    gone = [i for i, k in last.items() if k == "delete"]
    in_delta = set().union(*(m.entries for m in mut.sites.values()))
    if label == "cluster":
        sealed = [i for i in live if i in mut._id_lists]
    else:
        sealed = [i for i in live if ("node", i) in mut.store]
    applied = (all(i in sealed or i in in_delta for i in live)
               and all(i in mut.deleted for i in gone))
    c_run = counts()
    reset()
    gt = churn_ground_truth(data, stream, queries, K, device=dev)
    c = launches[f"write_path_{label}"] = {
        k: c_run[k] + v for k, v in counts().items()}
    dead = mut.deleted_array()
    merged = [mut.search(q, params) for q in queries[:64]]
    leaked = sum(len(np.intersect1d(r.ids, dead)) for r in merged)
    want = churn_ground_truth(data, stream, queries[:64], K, device="cpu")
    corpus, cids = churned_corpus(data, stream)
    xs = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(dev)
    q64 = torch.from_numpy(np.ascontiguousarray(queries[:64], np.float32)).to(dev)
    tol64 = TOL * ((q64 * q64).sum(-1) + (xs * xs).sum(-1).max()) + 1e-6
    pos = lambda ids: torch.from_numpy(np.searchsorted(cids, ids)).to(dev)
    n_diff, ties = near_tie_rows(pos(gt[:64]), pos(want), q64, xs, tol64)
    del xs
    torch.cuda.empty_cache()
    d = ing.to_dict(rep.records)
    lags = np.asarray(ing.visibility_lags)
    out = report.setdefault("write_path", {})[label] = {
        "queries": len(queries), "updates": len(stream),
        "inserts": stream.n_inserts, "deletes": stream.n_deletes,
        "virtual_qps": rep.summary()["qps"],
        "p99_s": rep.summary()["p99_latency_s"],
        "recall@10_churned": rep.recall_against(gt), "ingest": d,
        "freshness_lag_p50_s": float(np.percentile(lags, 50)),
        "freshness_lag_p99_s": float(np.percentile(lags, 99)),
        "sealed_inserts": len(sealed), "wall_s": wall,
        "gt_rows_differing_from_plain": n_diff, "launches": c}
    print(f"write path {label}: {len(queries)} queries, {len(stream)} updates "
          f"({stream.n_inserts} inserts, {stream.n_deletes} deletes), "
          f"{d['ops_delivered']} deliveries to sites, {ing.updates_applied} "
          f"applies; virtual {out['virtual_qps']} queries/s, p99 "
          f"{out['p99_s'] * 1e3:.3f} ms; recall@10 against the churned ground "
          f"truth {out['recall@10_churned']:.4f}; {d['flushes']} flushes, "
          f"{d['lists_rewritten']} lists rewritten, {d['reclusters']} splits, "
          f"{d['blocks_rewritten']} blocks rewritten, {d['repairs']} repaired "
          f"nodes, {len(sealed)} of {len(live)} live inserts sealed "
          f"(stitched into the graph for a graph index); write amplification "
          f"{d['write_amplification']}; freshness lag p50 "
          f"{out['freshness_lag_p50_s'] * 1e3:.3f} ms, p99 "
          f"{out['freshness_lag_p99_s'] * 1e3:.3f} ms; launches {c}; "
          f"simulation wall {wall:.3f} s")
    print(f"write path {label}: churned ground truth on the card vs the plain "
          f"version, 64 queries: {n_diff} rows differ, all near-ties: {ties}; "
          f"deleted ids in the merged search of 64 queries: {leaked}")
    require(ing.updates_applied >= len(stream) and applied,
            f"write path {label}: not every update was applied")
    require(leaked == 0, f"write path {label}: {leaked} deleted ids returned")
    require(ties, f"write path {label}: churned ground truth on the card "
            f"differs from the plain version beyond near-ties")


def serve_fleet(label, index, queries, params, gt, table_path, report,
                launches):
    """Serve ``queries`` through the fleet (4 shards x 2 replicas, hedged,
    ``tos`` storage, the kernel backend priced from ``table_path``); prints
    and reports what the fleet measured and returns its report."""
    from repro_torch.fleet import FleetRouter

    cfg = fleet_config(table_path)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # run_fleet's one call, kept as a router so its backends can be read
    router = FleetRouter(index, cfg)
    rep = router.run(queries, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = launches[f"fleet_{label}"] = counts()
    backends = [srv.engine.backend for g in router.groups
                for srv in g.all_servers() if srv.engine.backend is not None]
    batches = sum(be.batches for be in backends)
    s = rep.summary()
    f = report.setdefault("fleet", {})[label] = {
        "config": cfg.to_dict(), "queries": len(queries),
        "virtual_qps": s["qps"], "p50_s": s["p50_latency_s"],
        "p99_s": s["p99_latency_s"], "p999_s": s["p999_latency_s"],
        "hedge_rate": s["hedge_rate"], "shed_rate": s["shed_rate"],
        "backend_instances": len(backends), "backend_batches": batches,
        "jobs_batched": sum(be.jobs_batched for be in backends),
        "mean_occupancy": (sum(be.occupancy_sum for be in backends) / batches
                           if batches else 0.0),
        "recall@10": rep.recall_against(gt),
        "roundtrips": sum(r.metrics.roundtrips for r in rep.records),
        "wall_s": wall, "launches": c}
    require(len(rep.records) == len(queries) and s["shed_rate"] < 1.0,
            f"fleet ({label}) served {len(rep.records)} of {len(queries)}")
    print(f"fleet {label}: {len(queries)} queries, virtual {f['virtual_qps']:.1f} "
          f"queries/s, p50 {f['p50_s'] * 1e3:.3f} ms, p99 {f['p99_s'] * 1e3:.3f} ms, "
          f"p99.9 {f['p999_s'] * 1e3:.3f} ms; hedge rate {f['hedge_rate']}, shed "
          f"rate {f['shed_rate']}; KernelBackend {batches} batches over "
          f"{len(backends)} instances, mean occupancy {f['mean_occupancy']:.4f}; "
          f"recall@10 {f['recall@10']:.4f}; {f['roundtrips']} round trips; "
          f"launches {c}; simulation wall {wall:.3f} s")
    return rep


#: the ``tenants.json`` of ``docs/tenancy.md``
CLI_TENANTS = [
    {"name": "search-hot", "n": 600, "dim": 32, "nprobe": 8,
     "scenario": "trace", "rate_qps": 250, "slo_ms": 60, "weight": 2.0},
    {"name": "analytics", "n": 1200, "dim": 32, "nprobe": 64,
     "scenario": "burst", "burst_factor": 10, "slo_ms": 150, "weight": 1.0},
]
#: the reference CLI's virtual queries/s for ``--index graph --hedge
#: --replicas 2`` (``python -m repro.fleet``, the same flags)
GRAPH_CLI_QPS = 60.3254


def fleet_cli(report) -> None:
    """``python -m repro_torch.fleet`` on the card as a user runs it: the
    cluster fleet twice (the JSON, ``meta`` aside, must be the same), the
    graph fleet, which must give the reference's virtual queries/s, the
    write path (``docs/ingest.md``'s command) and the tenants of
    ``docs/tenancy.md`` with a weighted 4 MiB cache, each of which must
    give one JSON; the five processes run at once.  (The ``--device cpu``
    runs are the CPU parity tests': ``tests/test_torch_serving.py`` holds
    them to the reference.)"""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    tmp = tempfile.TemporaryDirectory()
    spec = Path(tmp.name) / "tenants.json"
    spec.write_text(json.dumps(CLI_TENANTS))
    cluster = ["--shards", "4", "--replicas", "2", "--backend", "kernel"]
    graph = ["--index", "graph", "--hedge", "--replicas", "2"]
    rw = ["--scenario", "rw", "--write-rate", "400", "--n-updates", "200",
          "--delta-kb", "64"]
    tenants = ["--tenants", str(spec), "--cache-mb", "4", "--cache-policy",
               "weighted"]
    runs = {}
    cmds = {name: [sys.executable, "-m", "repro_torch.fleet", "--compact",
                   *flags]
            for name, flags in (("cluster", cluster), ("cluster_again", cluster),
                                ("graph", graph), ("rw", rw),
                                ("tenants", tenants))}
    done = run_together(cmds, env, CLI_TIMEOUT_S)
    for name, (rc, stdout, stderr, wall) in done.items():
        flags = cmds[name][4:]
        require(rc == 0, f"fleet CLI {name} exited {rc}: {stderr[-2000:]}")
        try:
            out = json.loads(stdout)
        except json.JSONDecodeError:
            out = None
        require(isinstance(out, dict) and "recall" in out,
                f"fleet CLI {name} printed no JSON report with a recall")
        out.pop("meta", None)
        runs[name] = json.dumps(out, sort_keys=True)
        rep = out["report"]
        qps = rep.get("qps", rep.get("aggregate_goodput_qps"))
        p99 = rep.get("p99_latency_s",
                      {t["name"]: t["p99_latency_s"] for t in rep.get("tenants", [])})
        r = report.setdefault("fleet_cli", {})[name] = {
            "flags": flags, "wall_s": wall, "recall": out["recall"],
            "qps": qps, "p99_s": p99}
        if "ingest" in rep:
            r["ingest"] = {k: rep["ingest"][k] for k in (
                "ops_delivered", "flushes", "lists_rewritten",
                "write_amplification")}
        print(f"fleet CLI {name} ({' '.join(flags)}): recall {out['recall']}, "
              f"virtual {qps} queries/s{' (aggregate goodput)' if 'tenants' in rep else ''}, "
              f"p99 {p99} s, {wall:.3f} s wall (the five run together)")
    tmp.cleanup()
    require(runs["cluster"] == runs["cluster_again"],
            "the fleet CLI's cluster JSON differs between two runs on the card")
    g = report["fleet_cli"]
    print(f"fleet CLI: two cluster runs on the card identical; graph "
          f"{g['graph']['qps']} virtual queries/s (the reference's "
          f"{GRAPH_CLI_QPS}); rw and --tenants one JSON each")
    require(g["graph"]["qps"] == GRAPH_CLI_QPS,
            f"the graph CLI on the card gives {g['graph']['qps']} virtual "
            f"queries/s, not the reference's {GRAPH_CLI_QPS}")


#: the tuner's shapes: a rung's exact ground truth at dim 960 (the largest
#: rung: 56 queries x 3,000 points), the closure of a sweep's cluster build
#: (the 1,200 points of ``tuning/fleet.py``'s ``eval_n`` against the 256
#: leaves the BKT makes of them at ``ClusterIndexParams``' defaults, k =
#: num_replica 8, and 4 of ``REPLICA_GRID``), and a graph candidate's ADC
#: round at m = default_pq_dims(960) on the direct path (up to
#: pq_adc.SMALL_N rows)
TUNER_TOPK = (56, 3000, 960, K)
TUNER_CLOSURE = (1200, 960, (8, 4))
TUNER_ADC = (4096, 120)


def tuner_kernels(dev, peaks, kernels, report) -> None:
    """``l2_topk`` and ``adc_lookup`` at the tuner's shapes against their
    plain versions, timed beside their bound and the PyTorch calls; the
    results join the kernels' lines as ``tuner_shape``."""
    from repro_torch.core.cluster_index import ClusterIndex
    from repro_torch.core.types import ClusterIndexParams
    from repro_torch.data.synth import DatasetSpec, make_dataset

    Q, N, D, k = TUNER_TOPK
    data, queries = make_dataset(DatasetSpec(
        "tuner-analog", D, "float32", N, Q, n_clusters=64, intrinsic_dim=32,
        seed=0))                                # the tuner's rung recipe
    x = torch.from_numpy(data).to(dev)
    q = torch.from_numpy(queries).to(dev)
    topk = topk_case("tuner rung ground truth", q, x, k, peaks, reps=(50, 20),
                     device=True)
    err = topk["max_abs_err"]

    n, D, ks = TUNER_CLOSURE
    data, _ = make_dataset(DatasetSpec(
        "fleet-analog", D, "float32", n, 48, n_clusters=64, intrinsic_dim=32,
        seed=0))                                # the fleet sweep's recipe
    cents = ClusterIndex.build(data, ClusterIndexParams(
        kmeans_iters=4, seed=0), device=dev).meta.tree.centroids
    pts = torch.from_numpy(data).to(dev)
    cents = torch.from_numpy(cents).to(dev)
    closure = [topk_case("tuner closure", pts, cents, r, peaks, reps=(50, 20),
                         device=True) for r in ks]
    err = max(err, *(c["max_abs_err"] for c in closure))
    topk["closure"] = closure

    N, m = TUNER_ADC
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(rng.integers(0, 256, (N, m), dtype=np.uint8)).to(dev)
    tab = torch.from_numpy(rng.random((m, 256), dtype=np.float32)).to(dev)
    adc = adc_case("tuner graph round at dim 960", codes, tab, 200, 50, dev, peaks)
    require(adc["path"] == "direct", "the tuner's ADC shape is not on the direct path")
    for kern in kernels:
        if kern["name"] == "l2_topk":
            kern["tuner_shape"] = topk
            kern["max_abs_err"] = max(kern["max_abs_err"], err)
        elif kern["name"] == "adc_lookup":
            kern["tuner_shape"] = adc
            kern["max_abs_err"] = max(kern["max_abs_err"], adc["max_abs_err"])
    report["tuner_kernels"] = {"l2_topk": topk, "adc_lookup": adc}
    del x, q, pts, cents, codes, tab
    torch.cuda.empty_cache()


#: the commands of ``docs/tuning.md`` at the CLI's defaults: (name, flags,
#: keys its JSON must carry); "tenants.json" stands for the file of
#: ``docs/tenancy.md``
TUNER_RUNS = (
    ("screen", ["--budget", "screen"],
     {"recommendation", "screen", "pareto_frontier"}),
    ("index", ["--recall", "0.95", "--concurrency", "64", "--dim", "960",
               "--storage", "tos"],
     {"recommendation", "screen", "pareto_frontier"}),
    ("fleet", ["--fleet", "--backend", "kernel", "--scenario", "poisson",
               "--rate", "400"],
     {"recommendation", "sweep", "meets_slo", "scenario"}),
    ("window", ["--tune-window", "--scenario", "poisson", "--rate", "400"],
     {"recommendation", "sweep", "fleet", "meets_target"}),
    ("split", ["--tune-split", "--tenants", "tenants.json", "--cache-gb", "0.004"],
     {"recommendation", "screened", "refined"}),
    ("tier", ["--tune-tier", "--budget-usd-hour", "2.0", "--pricebook",
              "default"],
     {"recommendation", "screened", "refined"}),
    ("write", ["--write-rate", "400"], {"recommendation", "ingest"}),
)
#: runs repeated with ``--device cpu``: the screen measures no index, so its
#: JSON must equal the card's (the index runs' CPU parity with the
#: reference is the CPU parity tests', ``tests/test_torch_tuning_cli.py``)
TUNER_CPU = ("screen",)


def _tuner_json(argv: list[str]) -> tuple[dict, float]:
    """``python -m repro_torch.tuning`` in this process: its JSON, ``meta``
    aside, and its wall seconds."""
    import contextlib
    import io

    from repro_torch.tuning.__main__ import main as tuning_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tuning_main([*argv, "--compact"])
    wall = time.perf_counter() - t0
    require(rc == 0, f"tuner {' '.join(argv)} returned {rc}")
    try:
        out = json.loads(buf.getvalue())
    except json.JSONDecodeError:
        out = None
    require(isinstance(out, dict), f"tuner {' '.join(argv)} printed no JSON")
    out.pop("meta", None)
    return out, wall


def tuner(report, launches) -> None:
    """The seven tuner commands on the card (launches counted a run), three
    of them again on the CPU, and the quick index run as a subprocess."""
    root = Path(__file__).resolve().parent
    tmp = tempfile.TemporaryDirectory()
    spec = Path(tmp.name) / "tenants.json"
    spec.write_text(json.dumps(CLI_TENANTS))
    runs = report.setdefault("tuner", {})
    outs = {}
    for name, flags, keys in TUNER_RUNS:
        argv = [str(spec) if f == "tenants.json" else f for f in flags]
        reset()
        out, wall = _tuner_json(argv)
        c = launches[f"tuner_{name}"] = counts()
        require(keys <= set(out), f"tuner {name}: JSON lacks "
                f"{sorted(keys - set(out))}")
        outs[name] = out
        runs[name] = {"flags": argv, "wall_s": wall, "launches": c,
                      "recommendation": out["recommendation"]}
        print(f"tuner {name} ({' '.join(flags)}): recommendation "
              f"{json.dumps(out['recommendation'])}; {wall:.3f} s wall; "
              f"l2_topk {c['l2_topk']}, adc_lookup {c['adc_lookup']}, "
              f"l2_distance {c['l2_distance']} launches")
        require(name == "screen" or c["l2_topk"] > 0,
                f"tuner {name} built its indexes without launching l2_topk")
    for name in TUNER_CPU:
        out, wall = _tuner_json(runs[name]["flags"] + ["--device", "cpu"])
        same = out == outs[name]
        runs[name]["equals_cpu"] = same
        runs[name]["cpu_wall_s"] = wall
        print(f"tuner {name} with --device cpu: {wall:.3f} s wall; JSON equal "
              f"to the card's: {same}")
    require(runs["screen"]["equals_cpu"],
            "tuner --budget screen: the card's JSON differs from the CPU's")
    tmp.cleanup()
    flags = next(f for n, f, _ in TUNER_RUNS if n == "index")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuning", "--compact", *flags],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"python -m repro_torch.tuning exited "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    try:
        out = json.loads(proc.stdout)
    except json.JSONDecodeError:
        out = None
    require(isinstance(out, dict) and "recommendation" in out,
            "python -m repro_torch.tuning printed no JSON recommendation")
    out.pop("meta", None)
    runs["index_subprocess"] = {"wall_s": wall,
                                "equals_in_process": out == outs["index"]}
    print(f"python -m repro_torch.tuning {' '.join(flags)}: {wall:.3f} s wall, "
          f"one JSON; equal to the in-process run: {out == outs['index']}")
    total = {k: sum(launches[f"tuner_{n}"][k] for n, _, _ in TUNER_RUNS)
             for k in ("l2_topk", "adc_lookup")}
    print(f"tuner launches on the card: {json.dumps(total)}")
    require(total["l2_topk"] > 0 and total["adc_lookup"] > 0,
            f"the tuner runs launched {total}: l2_topk and adc_lookup must run")


#: the sharded step's shapes: a batch of queries against the 1M index's
#: lists on one rank; the k-means step's points and centroids
SHARD_QUERIES, SHARD_NPROBE = 512, 16
KMEANS_N, KMEANS_K = 100_000, 1024
KMEANS_RTOL = 1e-5


def _probe_tie(d_card, d_cpu, nprobe, q, cents, tol_row) -> torch.Tensor:
    """Rows whose probed lists differ, each only by centroids tied at the
    nprobe-th place: the exact (float64) distances of the lists either side
    probed and the other did not lie within 2 * tol of that place's."""
    from repro_torch.core.distances import topk_smallest
    pc = topk_smallest(d_card, nprobe)[1].cpu().sort(1).values
    pp = topk_smallest(d_cpu, nprobe)[1].sort(1).values
    rows = (pc != pp).any(1).nonzero()[:, 0]
    for r in rows.tolist():
        qd = q[r].double()
        ex = ((cents.double() - qd) ** 2).sum(-1)
        edge = ex.sort().values[nprobe - 1]
        swapped = torch.tensor(sorted(set(pc[r].tolist()) ^ set(pp[r].tolist())))
        require(bool(((ex[swapped.to(ex.device)] - edge).abs()
                      <= 2 * tol_row[r]).all()),
                f"sharded search: query {r} probed other lists on the card "
                f"than on the CPU, beyond a near-tie at place {nprobe}")
    return rows


def sharded(dev, data, queries, arrs, dv, report, launches) -> None:
    """``core/distributed.py`` on the card: one NCCL rank (a ``file://``
    store in a temporary directory) runs the sharded search step over the
    whole cluster index and a k-means step; a ``gloo`` group of the same
    rank runs both on the CPU with the plain versions, and the card must
    agree with it (ids up to near-ties, distances within the f32 tolerance;
    centroids within rtol 1e-5 except those a near-tie point moved)."""
    import torch.distributed as dist

    from repro_torch.core.distributed import (sharded_kmeans_step,
                                              sharded_search_step)
    from repro_torch.kernels import distance
    from repro_torch.kernels.ref import l2_distance_ref

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/store",
                            rank=0, world_size=1, device_id=dev)
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        cents, vecs, ids = dv["centroids"], dv["list_vecs"], dv["list_ids"]
        norms = (vecs * vecs).sum(-1)
        q = torch.from_numpy(queries[:SHARD_QUERIES]).to(dev)
        step = sharded_search_step(nprobe_local=SHARD_NPROBE, k=K)
        step(cents, vecs, ids, norms, q)              # warm-up (NCCL, cuBLAS)
        torch.cuda.synchronize()
        reset()
        got_ids, got_d = step(cents, vecs, ids, norms, q)
        torch.cuda.synchronize()
        c = launches["sharded_search"] = counts()
        require(c["l2_distance"] == 1 and c["topk_select"] == 3,
                f"the sharded search step launched {c}")
        ms = time_ms(lambda: step(cents, vecs, ids, norms, q), 10)
        cpu = [torch.from_numpy(arrs[key]) for key in
               ("centroids", "list_vecs", "list_ids")]
        want_ids, want_d = sharded_search_step(
            cpu_group, nprobe_local=SHARD_NPROBE, k=K)(
                *cpu, norms.cpu(), q.cpu())
        xs = torch.from_numpy(data).to(dev)
        row_tol = TOL * ((q * q).sum(-1) + (xs * xs).sum(-1).max()) + 1e-6
        probe_rows = _probe_tie(distance.l2_distance(q, cents),
                                l2_distance_ref(q.cpu(), cpu[0]), SHARD_NPROBE,
                                q, cents, row_tol)
        same_probe = torch.ones(len(q), dtype=torch.bool)
        same_probe[probe_rows] = False
        gi, wi = got_ids.cpu()[same_probe], want_ids[same_probe]
        n_diff, ties = near_tie_rows(gi.to(dev), wi.to(dev), q[same_probe.to(dev)],
                                     xs, row_tol[same_probe.to(dev)])
        err = (got_d.cpu() - want_d).abs()[same_probe]
        require(ties, f"sharded search: ids differ from the CPU's beyond "
                f"near-ties in {n_diff} rows")
        require(bool((err <= row_tol.cpu()[same_probe][:, None]).all()),
                f"sharded search: distances differ from the CPU's by {err.max()}")
        print(f"sharded search step, 1 NCCL rank, {len(q)} queries x "
              f"{cents.shape[0]} lists (max {vecs.shape[1]}), nprobe_local "
              f"{SHARD_NPROBE}, k={K}: {ms:.4f} ms a step (CUDA events), "
              f"l2_distance launches {c['l2_distance']}, topk_select "
              f"{c['topk_select']}; against the CPU (gloo): "
              f"{len(probe_rows)} rows probed other lists at a near-tie, "
              f"{n_diff} rows differ otherwise, all near-ties; max abs err "
              f"{float(err.max()):.3g}")
        # one more step under the profiler: launch/roofline.py's parser must
        # find its two all-gathers (f32 distances and int32 ids, B x k each)
        from repro_torch.launch import roofline as rf
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True) as prof, rf.annotate_groups():
            step(cents, vecs, ids, norms, q)
            torch.cuda.synchronize()
        trace = chrome_trace(prof)
        coll = {"counts": rf.count_collectives(trace),
                "bytes": rf.collective_bytes(trace),
                "links": rf.link_bytes(trace)}
        require(coll["counts"] == {"all-gather": 2}
                and coll["bytes"] == {"all-gather": len(q) * K * 8},
                f"sharded search: the profiler's trace reads as {coll}")
        print(f"sharded search step's trace through launch/roofline.py: "
              f"{coll}", flush=True)
        del norms, got_ids, got_d

        x = xs[:KMEANS_N]
        init = xs[KMEANS_N:KMEANS_N + KMEANS_K]
        kstep = sharded_kmeans_step()
        reset()
        got = kstep(x, init)
        torch.cuda.synchronize()
        kc = launches["sharded_kmeans"] = counts()
        require(kc["l2_distance"] == 1, f"the k-means step launched {kc}")
        kms = time_ms(lambda: kstep(x, init), 10)
        want = sharded_kmeans_step(cpu_group)(x.cpu(), init.cpu())
        # points the card and the CPU assign to other centroids must be
        # near-ties; the centroids they touch may move by a point's share
        a_card = distance.l2_distance(x, init).argmin(1).cpu()
        a_cpu = l2_distance_ref(x.cpu(), init.cpu()).argmin(1)
        moved = (a_card != a_cpu).nonzero()[:, 0]
        cn = (init * init).sum(-1)
        for i in moved.tolist():
            pair = torch.tensor([int(a_card[i]), int(a_cpu[i])], device=dev)
            ex = ((init[pair].double() - x[i].double()) ** 2).sum(-1)
            tol_i = TOL * float((x[i] * x[i]).sum() + cn[pair].max()) + 1e-6
            require(abs(float(ex[0] - ex[1])) <= 2 * tol_i,
                    f"k-means: point {i} moved beyond a near-tie")
        touched = set(a_card[moved].tolist()) | set(a_cpu[moved].tolist())
        keep = torch.tensor([j not in touched for j in range(KMEANS_K)])
        atol = KMEANS_RTOL * float(x.abs().max())
        kerr = (got.cpu() - want).abs()[keep]
        require(bool((kerr <= atol + KMEANS_RTOL * want[keep].abs()).all()),
                f"k-means step: centroids differ from the CPU's by {kerr.max()}")
        print(f"sharded k-means step, 1 NCCL rank, {KMEANS_N} points x "
              f"{KMEANS_K} centroids: {kms:.4f} ms a step (CUDA events), "
              f"l2_distance launches {kc['l2_distance']}; {len(moved)} points "
              f"near-tied, touching {len(touched)} clusters; the other "
              f"{int(keep.sum())} within rtol {KMEANS_RTOL} (atol {atol:.3g}), "
              f"max abs err {float(kerr.max()):.3g}")
        report["sharded"] = {
            "search": {"ms": ms, "launches": c, "collectives": coll,
                       "probe_near_ties": len(probe_rows),
                       "rows_differing": n_diff, "max_abs_err": float(err.max())},
            "kmeans": {"ms": kms, "launches": kc, "near_tie_points": len(moved),
                       "clusters_touched": len(touched),
                       "max_abs_err": float(kerr.max())}}
        del xs, x, init, got
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        tmp.cleanup()


#: the RAG corpus: 4,096 documents of 32 tokens (the reference driver's
#: --corpus 128 would leave the kernels almost nothing to do)
RAG_CORPUS, RAG_REQUESTS, RAG_TOKENS, RAG_K = 4096, 64, 8, 4
RAG_TIMED, RAG_CHECKED = 16, 4
#: bf16 logits against f32: |bf16 - f32| <= ATOL + RTOL * |f32|.  RTOL: the
#: logit itself is rounded to bf16 (half an ulp, 2^-9) after a product of
#: bf16-rounded operands (2^-9 each), with room for the rounding of the
#: final norm; ATOL: the rounding the hidden state gathers through 18
#: layers of bf16 residual adds and products (two layers at this width
#: gave 0.028 on logits of RMS 1.0 on the CPU), taken with a margin
BF16_ATOL, BF16_RTOL = 0.25, 2.0 ** -6


def _logit_check(got, want, what):
    err = (got - want).abs()
    excess = float((err - BF16_RTOL * want.abs()).max())
    require(excess <= BF16_ATOL, f"{what}: |bf16 - reference| exceeds "
            f"{BF16_ATOL} + {BF16_RTOL}*|reference| by {excess - BF16_ATOL}")
    return {"max_abs_err": float(err.max()),
            "rms_err": float(err.pow(2).mean().sqrt()),
            "max_err_less_rtol": excess}


def rag(dev, peaks, kernels, report, launches, cfg, corpus) -> dict:
    """``launch/serve.py``'s pipeline on the card at ``cfg``'s width: embed
    ``corpus`` documents and 64 requests, index them with
    ``ClusterIndex.build`` (closure through ``l2_topk``), retrieve, generate
    8 tokens a request; recall@4 against ``exact_topk`` at nprobe 8, 64 and
    every list (:func:`rag_recall_sweep`); prefill and decode
    time of 16 requests; the logits of 4 against the f32 and the bf16 full
    forward, teacher-forced; ``l2_topk`` at the closure's and the ground
    truth's shapes against its plain version.  Returns the LM's weights
    (a state dict on the card), for step 13."""
    import argparse
    import dataclasses

    from repro_torch.core.flat import exact_topk
    from repro_torch.core.types import recall_at_k
    from repro_torch.kernels.ref import full_f32_matmul
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import LM
    from repro_torch.serve.decode import decode_steps

    t0 = time.perf_counter()
    params = LM(cfg, seed=0, device="cpu").state_dict()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    print(f"RAG: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype} activations: {n_params} parameters "
          f"({4 * n_params / 1e9:.2f} GB f32), drawn on the CPU in "
          f"{init_s:.1f} s", flush=True)
    args = argparse.Namespace(arch=cfg.name, requests=RAG_REQUESTS,
                              tokens=RAG_TOKENS, corpus=corpus, k=RAG_K)
    reset()
    t0 = time.perf_counter()
    run = serve(cfg, params, args, dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    del params
    c = launches["rag_serve"] = counts()
    require(c["l2_topk"] == math.ceil(corpus / 4096),
            f"the RAG index build launched {c}")
    require(sorted(run.outputs) == list(range(RAG_REQUESTS)) and all(
        o.shape == (RAG_TOKENS,) and ((o >= 0) & (o < cfg.vocab)).all()
        for o in run.outputs.values()), "RAG: a request generated no tokens")
    require(np.isfinite(run.vecs).all() and np.isfinite(run.qv).all(),
            "RAG: embeddings not finite")
    reset()
    gt, _ = exact_topk(run.vecs, run.qv, RAG_K, device=dev)
    launches["rag_ground_truth"] = counts()
    rep = run.report
    recall = float(np.mean([recall_at_k(r.ids[:RAG_K], gt[r.qid])
                            for r in rep.records]))
    p50 = rep.latency_percentile(50)
    print(f"RAG retrieval: recall@{RAG_K} {recall:.4f} against exact_topk, "
          f"virtual p50 {p50 * 1e3:.3f} ms, {rep.mean_bytes_read / 1e3:.3f} "
          f"KB/query; serve {serve_s:.1f} s (embed, build, retrieve, "
          f"generate {RAG_REQUESTS} requests)", flush=True)
    sweep = rag_recall_sweep(run, gt, recall)

    lm = run.lm
    step_bytes = 8 * n_params      # f32 read 4, bf16 cast written 2, read 2
    pre_ms, dec_ms, checked = [], [], {}
    for qid in sorted(run.prompts)[:RAG_TIMED]:
        batch = {"tokens": torch.from_numpy(run.prompts[qid][None]).to(
            dev, torch.long)}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        it = decode_steps(lm, batch, RAG_TOKENS)
        steps = [next(it)]
        ev[1].record()
        steps += list(it)              # then the step after the last token
        ev[2].record()
        torch.cuda.synchronize()
        pre_ms.append(ev[0].elapsed_time(ev[1]))
        dec_ms.append(ev[1].elapsed_time(ev[2]) / RAG_TOKENS)
        toks = torch.stack([tok for _, tok in steps], 1)
        require(np.array_equal(toks[0].cpu().numpy(), run.outputs[qid]),
                f"RAG request {qid}: a second generation gave other tokens")
        if len(checked) < RAG_CHECKED:
            checked[qid] = (batch["tokens"], toks,
                            torch.cat([lg for lg, _ in steps]))
    print(f"RAG generation, {len(pre_ms)} requests of 64 prompt tokens: "
          f"prefill {np.median(pre_ms):.3f} ms (median; {min(pre_ms):.3f}-"
          f"{max(pre_ms):.3f}), decode {np.median(dec_ms):.3f} ms a token "
          f"(median; {min(dec_ms):.3f}-{max(dec_ms):.3f}), CUDA events; a "
          f"step's bytes (f32 weights read, their bf16 cast written and "
          f"read) take {step_bytes / peaks[1] * 1e3:.3f} ms at the card's "
          f"rate", flush=True)

    # one request's generation under the profiler: the card's busy time
    # against the wall time, and the kernels that take it
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in decode_steps(lm, batch, RAG_TOKENS):
            pass
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kern)
    gen_profile = {"wall_us": wall_us, "device_busy_us": busy_us,
                   "kernels": sum(e.count for e in kern),
                   "top_kernels_us": [(e.key[:60], round(e.self_device_time_total, 1))
                                      for e in kern[:6]]}
    print(f"RAG generation profile, one request (prefill + {RAG_TOKENS} "
          f"decode steps): wall {wall_us:.0f} us, device busy {busy_us:.0f} "
          f"us (idle share {1 - busy_us / wall_us:.3f}), "
          f"{gen_profile['kernels']} kernels; top (us): "
          f"{gen_profile['top_kernels_us']}", flush=True)

    # the cached bf16 logits against the teacher-forced full forward of the
    # same weights, in f32 (no TF32) and in bf16 (which checks the caches)
    lm32 = LM(dataclasses.replace(cfg, dtype="float32"), seed=None,
              device="meta")
    lm32.load_state_dict(lm.state_dict(), assign=True)
    checks = []
    with torch.no_grad():
        for qid, (prompt, toks, got) in checked.items():
            seq = torch.cat([prompt, toks[:, :-1]], 1)
            S = prompt.shape[1]
            with full_f32_matmul():
                f32 = lm32.logits({"tokens": seq})[0, S - 1:]
            b16 = lm.logits({"tokens": seq})[0, S - 1:]
            checks.append({
                "qid": qid,
                "vs_f32": _logit_check(got, f32, f"RAG request {qid}, f32"),
                "vs_bf16_full": _logit_check(got, b16, f"RAG request {qid}, bf16"),
                "top1_equal_f32": int((got.argmax(-1) == f32.argmax(-1)).sum()),
                "f32_logit_rms": float(f32.pow(2).mean().sqrt())})
            print(f"RAG request {qid}: prefill + {RAG_TOKENS - 1} decode "
                  f"steps' logits vs the f32 full forward "
                  f"{json.dumps(checks[-1]['vs_f32'])}, vs the bf16 full "
                  f"forward {json.dumps(checks[-1]['vs_bf16_full'])}; "
                  f"argmax equal to f32's at {checks[-1]['top1_equal_f32']} "
                  f"of {RAG_TOKENS} steps (logit RMS "
                  f"{checks[-1]['f32_logit_rms']:.3f})")
    del lm32, checked
    torch.cuda.empty_cache()

    # l2_topk at the pipeline's own shapes, against its plain version
    vecs = torch.from_numpy(run.vecs).to(dev)
    qv = torch.from_numpy(run.qv).to(dev)
    cents = torch.from_numpy(run.index.meta.tree.centroids).to(dev)
    cases = [topk_case("RAG closure", vecs[:4096], cents, 4, peaks,
                       reps=(50, 20), device=True),
             topk_case("RAG ground truth", qv, vecs, RAG_K, peaks,
                       reps=(50, 20), device=True)]
    for kern in kernels:
        if kern["name"] == "l2_topk":
            kern["rag_shapes"] = cases
            kern["max_abs_err"] = max(kern["max_abs_err"],
                                      *(c_["max_abs_err"] for c_ in cases))
    report["rag"] = {
        "config": cfg.name, "parameters": n_params, "init_s": init_s,
        "serve_s": serve_s, "recall": recall, "recall_sweep": sweep,
        "p50_s": p50,
        "kb_per_query": rep.mean_bytes_read / 1e3,
        "prefill_ms": pre_ms, "decode_ms_per_token": dec_ms,
        "decode_bound_ms": step_bytes / peaks[1] * 1e3,
        "generation_profile": gen_profile,
        "logit_checks": checks, "l2_topk": cases,
        "launches": {k: launches[k] for k in ("rag_serve", "rag_ground_truth")}}
    params = lm.state_dict()
    del run, lm, vecs, qv, cents
    torch.cuda.empty_cache()
    return params


def rag_recall_sweep(run, gt: np.ndarray, recall8: float) -> dict:
    """recall@4 of the RAG index at nprobe 8 (``launch/serve.py``'s), 64 and every
    list, on the same queries (host simulation over the card-built index),
    with the list count and the mean pairwise cosine of the document
    embeddings.  Every list makes the search exhaustive: its ids must be
    ``exact_topk``'s up to near-ties (the host scan and the kernel sum in
    other orders), and recall must not fall as nprobe grows."""
    from repro_torch.core.types import SearchParams, recall_at_k
    from repro_torch.serving.engine import run_workload
    from repro_torch.storage.spec import TOS

    n_lists = run.index.meta.n_lists
    recalls, t0 = {8: recall8}, time.perf_counter()
    for nprobe in (64, n_lists):
        rep = run_workload(run.index, run.qv, SearchParams(k=RAG_K,
                                                           nprobe=nprobe),
                           TOS, concurrency=RAG_REQUESTS)
        recalls[nprobe] = float(np.mean([recall_at_k(r.ids[:RAG_K], gt[r.qid])
                                         for r in rep.records]))
    got = np.stack([r.ids[:RAG_K] for r in
                    sorted(rep.records, key=lambda r: r.qid)])
    qt, xt = torch.from_numpy(run.qv), torch.from_numpy(run.vecs)
    tol_row = TOL * ((qt * qt).sum(-1) + (xt * xt).sum(-1).max()) + 1e-6
    n_diff, ties = near_tie_rows(torch.from_numpy(got), torch.from_numpy(gt),
                                 qt, xt, tol_row)
    require(ties, f"RAG: probing all {n_lists} lists, {n_diff} rows differ "
            f"from exact_topk beyond near-ties")
    require(recalls[8] <= recalls[64] <= recalls[n_lists],
            f"RAG: recall@{RAG_K} falls as nprobe grows: {recalls}")
    n = len(run.vecs)
    gram = run.vecs.astype(np.float64) @ run.vecs.T.astype(np.float64)
    cos = float((gram.sum() - np.trace(gram)) / (n * (n - 1)))
    print(f"RAG recall@{RAG_K} against exact_topk at nprobe 8 / 64 / all "
          f"{n_lists} lists: {recalls[8]:.4f} / {recalls[64]:.4f} / "
          f"{recalls[n_lists]:.4f} ({n_diff} of {len(got)} rows at every "
          f"list differ from exact_topk, all near-ties); mean pairwise "
          f"cosine of the {n} document embeddings {cos:.4f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"n_lists": n_lists, "recall": {str(k): v for k, v in recalls.items()},
            "all_lists_rows_differing": n_diff, "mean_pairwise_cosine": cos}


SERVE_CLI = ["-m", "repro_torch.launch.serve", "--arch", "gemma-2b",
             "--requests", "4", "--tokens", "8"]


def check_serve_cli(report, result) -> None:
    """``python -m repro_torch.launch.serve`` as a user runs it (the smoke
    config) on the card: it must exit 0 and print a line for each request
    (the ``--device cpu`` run is a CPU test's)."""
    rc, stdout, stderr, wall = result
    require(rc == 0, f"serve CLI exited {rc}: {stderr[-2000:]}")
    lines = stdout.splitlines()
    reqs = sorted(int(ln.split()[1].rstrip(":")) for ln in lines
                  if ln.startswith("request "))
    require(reqs == [0, 1, 2, 3], f"serve CLI printed requests {reqs}")
    report["serve_cli"] = {"card": {"wall_s": wall, "stdout": stdout}}
    print(f"serve CLI (card), {wall:.3f} s:\n{stdout.rstrip()}")


# ---- 13. training ---------------------------------------------------------

TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 6, 256, 8
TRAIN_PARAMS = 2_506_172_416          # gemma-2b at its full width
#: step 0's loss in the run against ``lm.loss`` of its batch under no_grad:
#: the same bf16 products on the same card (the checkpointed units only
#: recompute), so one f32 rounding of the mean
TRAIN_LOSS_RTOL = 1e-5
#: one step of a 1-layer model at gemma-2b's widths, f32 without TF32, card
#: against CPU: loss and grad_norm (sums over 2,048-256,000 terms in
#: another order), each gradient against its leaf's max |g|, and m = (1 -
#: b1) g; the parameters within 2 lr, since step 1's g/|g| flips with the
#: sign of a near-zero gradient
ONE_LAYER_RTOL = 1e-4
ONE_LAYER_SEQ, ONE_LAYER_BATCH = 64, 2
SMOKE_TRAIN_STEPS, PREEMPT_AT = 30, 12
#: the resumed run's parameters against the uninterrupted run's on one card:
#: the checkpoint round trip is exact, so only a nondeterministic reduction
#: on the card could move them
RESUME_ATOL = 1e-5


def train_bounds(cfg, n_params: int, batch: int, seq: int, peaks,
                 bf16_peak: float, passes: int = 4) -> dict:
    """The least time of one training step of the dense ``cfg`` with remat:
    operations, the matrix products of ``passes`` = 4 forward passes (the
    forward, the units' and loss chunks' recompute, and a backward of 2;
    3 without remat) at ``bf16_peak`` (the card's dense BF16 peak; its FP32
    peak for an f32 model), dense attention counting all seq x seq scores
    (they are masked, not skipped); bytes, the step function's inputs read once and
    outputs written once (f32 parameters, m and v: 24 bytes a parameter;
    the gradients are intermediates)."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    glu = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    layer = 2 * D * hd * (2 * H + 2 * KV) + 2 * glu * D * cfg.d_ff + 4 * seq * H * hd
    flops = passes * batch * seq * (cfg.n_layers * layer + 2 * D * cfg.vocab)
    nbytes = 24.0 * n_params
    ops_ms, bytes_ms = flops / bf16_peak * 1e3, nbytes / peaks[1] * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def roofline_terms(cfg, batch: int, seq: int, peaks, bf16_peak: float
                   ) -> dict:
    """The same step by ``launch/roofline.py``'s analytic model on one card:
    ``analytic_flops`` (4 forward passes' FLOPs under full remat) at the
    bf16 peak, ``analytic_bytes`` (parameters read as bf16 casts of the f32
    masters, the optimizer's p, m and v read and written, and ~12
    activation tensors a layer) at the card's memory rate."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline as rf
    shape = ShapeConfig("chip_smoke_train", seq_len=seq, global_batch=batch,
                        kind="train")
    flops = rf.analytic_flops(cfg, shape)
    nbytes = rf.analytic_bytes(cfg, shape, 1)
    ops_ms, bytes_ms = flops / bf16_peak * 1e3, nbytes / peaks[1] * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def chrome_trace(prof) -> dict:
    """The profiler's chrome trace, loaded."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def train_full(peaks, report, launches, cfg, params: dict) -> None:
    """``launch/train.py``'s ``build`` and ``train`` at ``cfg``'s full width
    on the card, on ``params`` (step 12's weights, which this empties): 6
    steps at batch 8 x 256; each step and its optimizer update timed with
    CUDA events, the peak memory, one more step under the profiler."""
    import statistics
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.hw import card_bf16_peak, smi_line
    from repro_torch.launch import train as lt
    from repro_torch.train import optimizer as opt

    assert cfg.family == "dense", cfg.family
    smi = smi_line(0)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    args = lt.build_parser().parse_args([
        "--arch", cfg.name, "--steps", str(TRAIN_STEPS), "--seq",
        str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--ckpt", tmp.name])
    try:
        lm = lt.build(args, params)                  # the default device
        params.clear()
        torch.cuda.empty_cache()
        n_params = sum(p.numel() for p in lm.parameters())
        require(lm.device.type == "cuda" and lm.cfg == cfg
                and n_params == TRAIN_PARAMS, f"training built {lm.cfg.name}, "
                f"{n_params} parameters on {lm.device}")
        with torch.no_grad():
            want0 = float(lm.loss(lt.batch_fn(lm.cfg, args, lm.device)(0)))

        step_ev, opt_ev, norms = [], [], []
        real_make, real_apply = lt.make_train_step, opt.apply_updates

        def events():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            return ev

        def timed_apply(*a, **kw):
            ev = events()
            out = real_apply(*a, **kw)
            ev[1].record()
            opt_ev.append(ev)
            return out

        def timed_make(*a, **kw):
            step = real_make(*a, **kw)

            def timed_step(lm, state, batch):
                ev = events()
                out = step(lm, state, batch)
                ev[1].record()
                step_ev.append(ev)
                norms.append(out[2]["grad_norm"])
                return out
            return timed_step

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        with mock.patch.object(lt, "make_train_step", timed_make), \
                mock.patch.object(opt, "apply_updates", timed_apply):
            lm, opt_state, rep = lt.train(lm, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launches["train_full"] = counts()
        peak = torch.cuda.max_memory_allocated()
        norms = [float(g) for g in norms]
        require(rep.steps_run == TRAIN_STEPS and len(rep.losses) == TRAIN_STEPS
                and all(math.isfinite(x) for x in rep.losses + norms),
                f"training: losses {rep.losses}, grad norms {norms}")
        require(abs(rep.losses[0] - want0) <= TRAIN_LOSS_RTOL * abs(want0),
                f"training: step 0's loss {rep.losses[0]} is not lm.loss of "
                f"its batch, {want0}")
        require(not any(c.values()), f"training launched {c}")
        step_ms = [a.elapsed_time(b) for a, b in step_ev]
        opt_ms = [a.elapsed_time(b) for a, b in opt_ev]
        med = statistics.median(step_ms[1:])
        med_opt = statistics.median(opt_ms[1:])
        tokens_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
        bf16_peak = card_bf16_peak(torch.cuda.get_device_name(0))
        bounds = train_bounds(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ, peaks,
                              bf16_peak)
        roof = roofline_terms(cfg, TRAIN_BATCH, TRAIN_SEQ, peaks, bf16_peak)
        print(f"training {cfg.name} at its full width ({n_params} parameters, "
              f"batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat, bf16 over f32 "
              f"weights) on {smi}: losses {[round(x, 4) for x in rep.losses]}, "
              f"grad norms {[round(x, 4) for x in norms]}; step 0's loss "
              f"{rep.losses[0]!r} vs lm.loss {want0!r}; {wall:.3f} s for "
              f"{TRAIN_STEPS} steps", flush=True)
        print(f"training step, median of steps 2-{TRAIN_STEPS} (CUDA events): "
              f"{med:.3f} ms ({[round(x, 3) for x in step_ms]}), "
              f"{tokens_s:.1f} tokens/s; AdamW {med_opt:.3f} ms "
              f"({[round(x, 3) for x in opt_ms]}), {med_opt / med:.3f} of a "
              f"step; peak memory {peak} bytes ({peak / 2**30:.2f} GiB); bound "
              f"{bounds['bound_ms']:.3f} ms ({bounds['bound_by']}: "
              f"{bounds['flops']:.4g} FLOP at the bf16 peak {bounds['ops_ms']:.3f} "
              f"ms, {bounds['bytes']:.4g} bytes {bounds['bytes_ms']:.3f} ms), "
              f"{bounds['bound_ms'] / med:.3f} of it; launches {c}", flush=True)
        print(f"training step by launch/roofline.py's model (one card): "
              f"operations {roof['flops']:.4g} FLOP, {roof['ops_ms']:.3f} ms at "
              f"the bf16 peak; bytes {roof['bytes']:.4g} (parameters, "
              f"optimizer and activations), {roof['bytes_ms']:.3f} ms; bound "
              f"{roof['bound_ms']:.3f} ms ({roof['bound_by']}), "
              f"{roof['bound_ms'] / med:.3f} of the median step; train_bounds "
              f"above: {bounds['ops_ms']:.3f} ms operations, "
              f"{bounds['bytes_ms']:.3f} ms bytes", flush=True)

        # one more step under the profiler: the card's busy time against the
        # wall time, and the kernels that take it
        step = real_make(lm, opt.OptimizerConfig(total_steps=args.steps))
        batch = lt.batch_fn(lm.cfg, args, lm.device)(TRAIN_STEPS)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = step(lm, opt_state, batch)
            float(m["loss"])
            wall_us = (time.perf_counter() - t0) * 1e6
        from repro_torch.launch import roofline as rf
        coll = rf.collective_bytes(chrome_trace(prof))
        require(coll == {}, f"one rank's training step recorded {coll}")
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in kern)
        # cuBLAS's products (nvjet / gemm / cutlass kernels) against the rest
        mm_us = sum(e.self_device_time_total for e in kern
                    if any(t in e.key.lower() for t in ("nvjet", "gemm",
                                                        "cutlass")))
        profile = {"wall_us": wall_us, "device_busy_us": busy_us,
                   "idle_share": 1 - busy_us / wall_us,
                   "busy_share_of_step": busy_us / (med * 1e3),
                   "matmul_us": mm_us, "kernels": sum(e.count for e in kern),
                   "collective_bytes": coll,
                   "top_kernels_us": [(e.key[:60], round(e.self_device_time_total, 1))
                                      for e in kern[:8]]}
        print(f"training step under the profiler: wall {wall_us:.0f} us, device "
              f"busy {busy_us:.0f} us (idle share {profile['idle_share']:.3f}; "
              f"{profile['busy_share_of_step']:.3f} of the unprofiled median "
              f"step), matrix products {mm_us:.0f} us, "
              f"{profile['kernels']} kernels; top (us): "
              f"{profile['top_kernels_us']}", flush=True)
        report["train"] = {
            "config": cfg.name, "parameters": n_params, "card": smi,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": rep.losses,
            "grad_norms": norms, "loss0_no_grad": want0, "wall_s": wall,
            "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": tokens_s,
            "adamw_ms": opt_ms, "adamw_ms_median": med_opt,
            "adamw_share": med_opt / med, "peak_bytes": peak,
            "bounds": bounds, "roofline": roof, "profile": profile,
            "launches": c}
        del lm, opt_state, step, batch, m
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    torch.cuda.empty_cache()


def train_one_layer(dev, report, cfg, state: dict) -> None:
    """One train step of a 1-layer model at ``cfg``'s widths (f32
    activations, no TF32, remat on) on the card and on the CPU from the
    weights ``state`` (the embedding, layer 0 and the final norm of step
    12's, on the host) and one batch, held to ``ONE_LAYER_RTOL``."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.ref import full_f32_matmul
    from repro_torch.models.model import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    batch = TokenPipeline(DataConfig(vocab=cfg1.vocab, seq_len=ONE_LAYER_SEQ,
                                     global_batch=ONE_LAYER_BATCH)).batch(0)
    ocfg = opt.OptimizerConfig(total_steps=TRAIN_STEPS)
    out = []
    for device in ("cpu", dev):
        t0 = time.perf_counter()
        lm = LM(cfg1, seed=None, device=device)
        lm.load_state_dict(state)
        st = opt.init_state(dict(lm.named_parameters()))
        with full_f32_matmul():
            lm, st, m = make_train_step(lm, ocfg)(lm, st, {
                k: torch.from_numpy(v).to(device, torch.long)
                for k, v in batch.items()})
        out.append((
            {k: float(v) for k, v in m.items()},
            {k: p.grad.cpu() for k, p in lm.named_parameters()},
            {k: v.cpu() for k, v in lm.state_dict().items()},
            {k: v.cpu() for k, v in st["m"].items()}, time.perf_counter() - t0))
        del lm, st
    torch.cuda.empty_cache()
    (cm, cg, cp, cmom, cs), (gm, gg, gp, gmom, gs) = out
    errs = {"loss": abs(gm["loss"] / cm["loss"] - 1),
            "grad_norm": abs(gm["grad_norm"] / cm["grad_norm"] - 1),
            "grad": max(float((gg[k] - cg[k]).abs().max() / cg[k].abs().max())
                        for k in cg),
            "m": max(float((gmom[k] - cmom[k]).abs().max() / cmom[k].abs().max())
                     for k in cmom),
            "param_abs": max(float((gp[k] - cp[k]).abs().max()) for k in cp)}
    lr = cm["lr"]
    print(f"training, 1 layer at {cfg.name}'s widths ({sum(v.numel() for v in state.values())} "
          f"parameters, batch {ONE_LAYER_BATCH} x {ONE_LAYER_SEQ}, f32 without "
          f"TF32): card loss {gm['loss']!r} vs CPU {cm['loss']!r}; relative "
          f"errors {json.dumps(errs)}; lr {lr!r}; card {gs:.3f} s, CPU {cs:.3f} s",
          flush=True)
    require(max(errs["loss"], errs["grad_norm"], errs["grad"], errs["m"])
            <= ONE_LAYER_RTOL and errs["param_abs"] <= 2 * lr + 1e-6,
            f"training: one layer on the card differs from the CPU: {errs}")
    report["train_one_layer"] = {"errors": errs, "lr": lr, "card_s": gs,
                                 "cpu_s": cs, "loss": gm["loss"]}


def train_smoke(dev, report, launches) -> None:
    """The smoke config through the runner on the card: 30 steps whose loss
    falls (``tests/test_train.py``'s test), and the same run preempted by
    SIGTERM at step 12 and resumed, which must end on the uninterrupted
    run's parameters within ``RESUME_ATOL``."""
    import signal

    from repro_torch.configs.archs import ARCHS, smoke
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.runner import RunnerConfig, run
    from repro_torch.train.train_step import make_train_step

    cfg = smoke(ARCHS["gemma-2b"])
    ocfg = opt.OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=200)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=0))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    before = signal.getsignal(signal.SIGTERM)

    def runner(ckdir, preempt_at=None):
        lm = LM(cfg, seed=0, device=dev)

        def next_batch(s):
            if s == preempt_at:
                require(signal.getsignal(signal.SIGTERM) is not before,
                        "the runner installed no SIGTERM handler")
                os.kill(os.getpid(), signal.SIGTERM)
            return {k: torch.from_numpy(v).to(dev, torch.long)
                    for k, v in pipe.batch(s).items()}
        return run(RunnerConfig(total_steps=SMOKE_TRAIN_STEPS,
                                ckpt_dir=os.path.join(tmp.name, ckdir),
                                ckpt_every=100, log_every=100),
                   make_train_step(lm, ocfg), lm,
                   opt.init_state(dict(lm.named_parameters())), next_batch,
                   log=lambda *_: None)

    reset()
    whole, _, rep = runner("whole")
    cut, _, rep_cut = runner("cut", PREEMPT_AT)
    resumed, _, rep_res = runner("cut")
    launches["train_smoke"] = counts()
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    diff = max(float((a - b).abs().max()) for a, b in zip(
        whole.state_dict().values(), resumed.state_dict().values()))
    print(f"training, smoke config on the card: {SMOKE_TRAIN_STEPS} steps, mean "
          f"loss of the first 5 {first:.4f}, of the last 5 {last:.4f}; "
          f"preempted at step {rep_cut.final_step} ({rep_cut.steps_run} run), "
          f"resumed for {rep_res.steps_run}: max |resumed - uninterrupted| "
          f"parameter {diff!r}", flush=True)
    require(last < first - 0.2, f"training: the smoke loss did not fall "
            f"({first} -> {last})")
    require(rep_cut.preempted and rep_cut.final_step == PREEMPT_AT + 1
            and rep_res.steps_run == SMOKE_TRAIN_STEPS - PREEMPT_AT - 1
            and rep_res.final_step == SMOKE_TRAIN_STEPS,
            f"training: preemption at step {PREEMPT_AT} gave {rep_cut} then "
            f"{rep_res}")
    require(diff <= RESUME_ATOL, f"training: the resumed run's parameters "
            f"differ from the uninterrupted run's by {diff}")
    report["train_smoke"] = {"losses": rep.losses, "first5": first,
                             "last5": last, "resume_max_abs_diff": diff}
    tmp.cleanup()


def check_train_cli(report, result) -> None:
    """``python -m repro_torch.launch.train --smoke --steps 3`` on the card
    as a user runs it: exit 0 and the reference's two lines."""
    rc, stdout, stderr, wall = result
    require(rc == 0, f"train CLI exited {rc}: {stderr[-2000:]}")
    lines = stdout.splitlines()
    require(lines[0].startswith("gemma-2b-smoke: ") and lines[-1].startswith(
        "done: 3 steps, loss "), f"train CLI printed {stdout!r}")
    report["train_cli"] = {"wall_s": wall, "stdout": stdout}
    print(f"train CLI on the card, {wall:.3f} s:\n{stdout.rstrip()}")


# ---- 14. training through DTensors, and the dry-run ----------------------

DT_STEPS, DT_BATCH, DT_SEQ = 3, 8, 64
#: the DTensor path on a 1x1 mesh runs the plain path's products in its
#: order: only the gradients' accumulation order may differ
DT_LOSS_RTOL = 1e-6
DRYRUN_CELLS = (("gemma-2b", "train_4k"), ("gemma-2b", "decode_32k"),
                ("vector-search", None))


def train_dtensor(dev, report, launches) -> None:
    """``launch/train.py`` on the smoke config twice on one NCCL rank: with
    plain tensors, and with DTensor parameters and batches on an explicit
    1x1 mesh (``build(args, mesh=...)``); 3 steps each, whose losses must
    agree within ``DT_LOSS_RTOL``."""
    import contextlib
    import io

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import train as lt
    from repro_torch.models import parallel

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dtensor_")
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/store",
                            rank=0, world_size=1, device_id=dev)
    try:
        runs = {}
        reset()
        for name in ("plain", "dtensor"):
            mesh = (DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
                    if name == "dtensor" else None)
            args = lt.build_parser().parse_args([
                "--arch", "gemma-2b", "--smoke", "--steps", str(DT_STEPS),
                "--batch", str(DT_BATCH), "--seq", str(DT_SEQ), "--ckpt",
                os.path.join(tmp.name, name)])
            with contextlib.redirect_stdout(io.StringIO()) as out:
                lm = lt.build(args, mesh=mesh)
                require(parallel.is_sharded(lm) == (mesh is not None)
                        and lm.device.type == "cuda",
                        f"train ({name}) built on {lm.device}, sharded "
                        f"{parallel.is_sharded(lm)}")
                t0 = time.perf_counter()
                _, _, rep = lt.train(lm, args)
                torch.cuda.synchronize()
            runs[name] = {"losses": rep.losses,
                          "wall_s": time.perf_counter() - t0,
                          "stdout": out.getvalue()}
        c = launches["train_dtensor"] = counts()
        require(not any(c.values()), f"training launched {c}")
        plain, sharded = runs["plain"]["losses"], runs["dtensor"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(sharded, plain))
        require(len(plain) == len(sharded) == DT_STEPS and rel <= DT_LOSS_RTOL,
                f"DTensor training: losses {sharded} vs plain {plain}")
        print(f"training through DTensors on a 1x1 mesh (one NCCL rank), "
              f"gemma-2b smoke, {DT_STEPS} steps at {DT_BATCH} x {DT_SEQ}: "
              f"losses {sharded} vs plain {plain}, max rel diff {rel:.3g}; "
              f"wall {runs['dtensor']['wall_s']:.3f} s vs "
              f"{runs['plain']['wall_s']:.3f} s", flush=True)
        report["train_dtensor"] = {"runs": runs, "max_rel_diff": rel,
                                   "launches": c}
    finally:
        dist.destroy_process_group()
        tmp.cleanup()


def check_dryrun(report, done: dict, outdir: str) -> None:
    """``python -m repro_torch.launch.dryrun`` as a user runs it, one
    subprocess a cell of ``DRYRUN_CELLS`` (``done``: their results by
    cell): each must exit 0 with status ``ok`` and a per-rank peak under
    the card's memory."""
    total = torch.cuda.get_device_properties(0).total_memory
    cells = {}
    for (arch, shape), (rc, _, stderr, wall) in done.items():
        tag = (f"{arch}_{shape}_32x8" if shape else "vector-search_32x8")
        require(rc == 0, f"dry-run {tag} exited {rc}: {stderr[-3000:]}")
        rec = json.loads(Path(outdir, tag + ".json").read_text())
        peak = rec["memory"]["peak_size_in_bytes"]
        require(rec["status"] == "ok" and peak < total,
                f"dry-run {tag}: status {rec['status']}, peak {peak} "
                f"bytes a rank of the card's {total}")
        roof = rec["roofline"]
        if shape is None:
            counted = rec["cost"]["flops_per_device"] * rec["chips"]
            analytic = roof["model_flops"]
            coll = rec["collective_bytes"]
        else:
            counted = (roof["raw_cost_analysis"]["flop_counter_per_device"]
                       * rec["chips"])
            analytic = roof["hlo_flops_global"]
            coll = roof["coll_breakdown"]
        trace_s = rec.get("trace_s")
        print(f"dry-run {tag} ({rec['chips']} fake ranks): {rec['status']}, "
              f"trace {trace_s} s, process {wall:.1f} s; peak "
              f"{peak / 2**30:.3f} GiB a rank of {total / 2**30:.1f} GiB "
              f"(arguments {rec['memory']['argument_size_in_bytes'] / 2**30:.3f} "
              f"GiB); FLOP counter x ranks {counted:.4g} vs analytic "
              f"{analytic:.4g} ({counted / analytic:.3f}); collectives "
              f"{rec['collective_counts']}, bytes a rank {coll}; roofline "
              f"compute {roof['compute_s']:.4g} s, memory "
              f"{roof['memory_s']:.4g} s, collective "
              f"{roof['collective_s']:.4g} s", flush=True)
        cells[tag] = {"process_s": wall, "record": rec}
    report["dryrun"] = cells


def clis(report) -> None:
    """The serve CLI, the train CLI and the dry-run's cells as users run
    them, each a subprocess, all five at once (none needs another's output;
    together they take about the slowest one's time)."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clis_") as d:
        cmds = {"serve": [sys.executable, *SERVE_CLI],
                "train": [sys.executable, "-m", "repro_torch.launch.train",
                          "--smoke", "--steps", "3", "--ckpt",
                          str(Path(d, "ckpt"))]}
        cells = {f"dryrun_{i}": cell for i, cell in enumerate(DRYRUN_CELLS)}
        for key, (arch, shape) in cells.items():
            cmds[key] = [sys.executable, "-m", "repro_torch.launch.dryrun",
                         *(["--vector-search"] if shape is None
                           else ["--arch", arch, "--shape", shape]),
                         "--out", d]
        done = run_together(cmds, dict(os.environ, PYTHONPATH=str(root / "src")),
                            CLI_TIMEOUT_S)
        check_serve_cli(report, done["serve"])
        check_train_cli(report, done["train"])
        check_dryrun(report, {cell: done[key] for key, cell in cells.items()}, d)


# ---- 15. the examples on the card -------------------------------------------

#: train_lm.py's defaults: 150 steps at 8 x 128, a checkpoint every 50
EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_BATCH, EXAMPLE_TRAIN_SEQ = 150, 8, 128
#: a quickstart line and the structures beneath it: a line may differ from
#: the CPU run's only where one of these differs (up to near-ties)
QUICKSTART_FEEDS = {"posting lists": ("cluster",), "SPANN ": ("cluster", "gt"),
                    "cluster: total": ("cluster",), "DiskANN ": ("graph", "gt")}


def load_example(name: str):
    """``examples/torch/<name>.py`` of this checkout, as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *a, **kw) -> tuple:
    """``fn``'s result, its printed lines and its wall seconds (synced)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, buf.getvalue().splitlines(), time.perf_counter() - t0


def closure_codes(index) -> set:
    """The cluster index's (list, point) pairs as ``list * n + point``."""
    n = index.meta.n_data
    return {li * n + int(p) for li in range(index.meta.n_lists)
            for p in index.store.get(("list", li))[0]}


def example_quickstart(dev, launches) -> dict:
    """``quickstart.py`` on the card, then on the CPU: the card's run must
    launch ``l2_topk`` and ``adc_lookup``, and every line must equal the
    CPU's unless a structure beneath it differs, each such difference a
    near-tie (ground-truth rows, closure pairs) or counted (the graph's
    adjacency rows and PQ codes, which the card's greedy search and PQ
    training sum in another order)."""
    mod = load_example("quickstart")
    reset()
    card, lines, card_s = captured(mod.main, ["--device", "cuda"])
    c = launches["example_quickstart"] = counts()
    require(c["l2_topk"] > 0 and c["adc_lookup"] > 0,
            f"quickstart on the card launched {c}")
    cpu, cpu_lines, cpu_s = captured(mod.main, ["--device", "cpu"])
    print(f"example quickstart on the card, {card_s:.3f} s (the CPU's run "
          f"{cpu_s:.3f} s); launches {c}:\n" + "\n".join(lines), flush=True)
    require(len(lines) == len(cpu_lines),
            f"quickstart: {len(lines)} lines on the card, {len(cpu_lines)} on "
            f"the CPU")

    q = torch.from_numpy(card["queries"]).to(dev)
    x = torch.from_numpy(card["data"]).to(dev)
    tol_row = TOL * ((q * q).sum(-1) + (x * x).sum(-1).max()) + 1e-6
    gt_rows, ties = near_tie_rows(torch.from_numpy(card["gt"]).to(dev),
                                  torch.from_numpy(cpu["gt"]).to(dev), q, x,
                                  tol_row)
    require(ties, f"quickstart: exact_topk differs from the CPU's beyond "
            f"near-ties in {gt_rows} rows")
    ci, cci = card["cluster"], cpu["cluster"]
    cents = ci.meta.tree.centroids
    require(np.array_equal(cents, cci.meta.tree.centroids),
            "quickstart: the host BKT gave other centroids on the card's run")
    cents64 = torch.from_numpy(cents.astype(np.float64)).to(dev)
    cn64 = (cents64 * cents64).sum(-1)
    p_ = ci.meta.params
    thresh, r = (1.0 + p_.closure_eps) ** 2, min(p_.num_replica, len(cents))
    flipped = closure_codes(ci) ^ closure_codes(cci)
    for code in flipped:
        li, pt = divmod(code, ci.meta.n_data)
        xp = torch.from_numpy(card["data"][pt].astype(np.float64)).to(dev)
        require(flip_at_boundary(xp, li, cents64, cn64, thresh, r),
                f"quickstart: closure pair (point {pt}, list {li}) differs "
                f"from the CPU's away from the threshold and the rank-{r} "
                f"boundary")
    gi, cgi = card["graph"], cpu["graph"]
    adj_rows = sum(not np.array_equal(gi.store.get(("node", i))[1],
                                      cgi.store.get(("node", i))[1])
                   for i in range(gi.meta.n_data))
    code_rows = int((gi.meta.codes != cgi.meta.codes).any(1).sum())
    beneath = {"gt": gt_rows > 0, "cluster": bool(flipped),
               "graph": adj_rows > 0 or code_rows > 0}
    differing = [(a, b) for a, b in zip(lines, cpu_lines) if a != b]
    for a, b in differing:
        feeds = [f for key, fs in QUICKSTART_FEEDS.items() if key in a
                 for f in fs]
        print(f"quickstart line differs: card {a!r}, CPU {b!r}")
        require(any(beneath[f] for f in feeds), f"quickstart: a line differs "
                f"with nothing beneath it differing: {a!r} vs {b!r}")
    print(f"quickstart card vs CPU: {len(differing)} of {len(lines)} lines "
          f"differ; beneath them {gt_rows} ground-truth rows (near-ties), "
          f"{len(flipped)} closure pairs (at the boundary), {adj_rows} graph "
          f"adjacency rows and {code_rows} PQ code rows of "
          f"{gi.meta.n_data}", flush=True)
    return {"card_s": card_s, "cpu_s": cpu_s, "lines": lines,
            "cpu_lines": cpu_lines, "launches": c, "gt_rows": gt_rows,
            "closure_pairs_flipped": len(flipped), "adjacency_rows": adj_rows,
            "code_rows": code_rows}


def example_cloud_tuning(launches) -> dict:
    """``cloud_tuning.py``'s screen on the card and on the CPU: host
    arithmetic, so the same lines."""
    mod = load_example("cloud_tuning")
    reset()
    _, lines, card_s = captured(mod.main, ["--device", "cuda"])
    c = launches["example_cloud_tuning"] = counts()
    _, cpu_lines, cpu_s = captured(mod.main, ["--device", "cpu"])
    require(lines == cpu_lines, "cloud_tuning: the card's screen printed "
            "other lines than the CPU's")
    print(f"example cloud_tuning (screen) on the card, {card_s:.3f} s (CPU "
          f"{cpu_s:.3f} s), {len(lines)} lines equal to the CPU's; launches "
          f"{c}:\n" + "\n".join(lines), flush=True)
    return {"card_s": card_s, "cpu_s": cpu_s, "lines": lines, "launches": c}


def example_rag(launches) -> dict:
    """``rag_serving.py`` on the card, then on the CPU, on the same weights:
    the tokens in the vocabulary, and each query's retrieved documents the
    CPU's up to near-ties: where they differ, their float64 distances under
    the CPU's embeddings, sorted, within what the two runs' embedding
    difference ``e`` (the largest L2 norm of a vector's difference) can
    move a squared distance between unit vectors, 8e + 4e^2, twice, plus the
    f32 tolerance."""
    mod = load_example("rag_serving")
    reset()
    card, lines, card_s = captured(mod.main, ["--device", "cuda"])
    c = launches["example_rag_serving"] = counts()
    require(c["l2_topk"] >= 1, f"rag_serving on the card launched {c}")
    cpu, cpu_lines, cpu_s = captured(mod.main, ["--device", "cpu"])
    vocab = mod.smoke(mod.ARCHS["gemma-2b"]).vocab
    require(((card["tokens"] >= 0) & (card["tokens"] < vocab)).all(),
            f"rag_serving: tokens outside the vocabulary: {card['tokens']}")
    eps = max(float(np.linalg.norm(card[k] - cpu[k], axis=1).max())
              for k in ("doc_vecs", "query_vecs"))
    tol = 2 * (8 * eps + 4 * eps ** 2) + 2 * TOL * 2 + 1e-6
    x64, q64 = cpu["doc_vecs"].astype(np.float64), cpu["query_vecs"].astype(np.float64)
    rows = [sorted(rep.records, key=lambda r: r.qid)
            for rep in (card["report"], cpu["report"])]
    n_diff = 0
    for rc, rp in zip(*rows):
        a, b = rc.ids[:4], rp.ids[:4]
        if np.array_equal(a, b):
            continue
        n_diff += 1
        da, db = (np.sort(((x64[ids] - q64[rc.qid]) ** 2).sum(-1))
                  for ids in (a, b))
        require(bool((np.abs(da - db) <= tol).all()),
                f"rag_serving query {rc.qid}: documents {a.tolist()} on the "
                f"card, {b.tolist()} on the CPU, beyond a near-tie "
                f"({np.abs(da - db).max():.3g} > {tol:.3g})")
    print(f"example rag_serving on the card, {card_s:.3f} s (CPU {cpu_s:.3f} "
          f"s); launches {c}:\n" + "\n".join(lines), flush=True)
    print(f"rag_serving card vs CPU: embeddings within {eps:.3g} (L2); "
          f"retrieved documents differ in {n_diff} of {len(rows[0])} queries, "
          f"all near-ties; tokens card {card['tokens'].tolist()}, CPU "
          f"{cpu['tokens'].tolist()} (equal: "
          f"{bool(np.array_equal(card['tokens'], cpu['tokens']))})", flush=True)
    return {"card_s": card_s, "cpu_s": cpu_s, "lines": lines,
            "cpu_lines": cpu_lines, "embedding_diff_l2": eps,
            "queries_differing": n_diff, "launches": c}


def example_train(peaks, launches) -> dict:
    """``train_lm.py`` at its full 100M width on the card, as a user runs it
    (150 steps at 8 x 128, a checkpoint every 50) in a fresh ``--ckpt``: it
    must pass its own "loss fell" check; each step and AdamW update timed
    with CUDA events, each checkpoint's save on the host clock, the peak
    memory.  A second call on the same directory must resume at step 150
    and run no step."""
    import statistics
    from unittest import mock

    from repro_torch.hw import smi_line
    from repro_torch.train import optimizer as opt
    from repro_torch.train import runner

    mod = load_example("train_lm")
    cfg = mod.CFG_100M
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_example_train_")
    argv = ["--device", "cuda", "--ckpt", tmp.name]
    step_ev, opt_ev, save_s = [], [], []
    real_make, real_apply, real_save = (mod.make_train_step, opt.apply_updates,
                                        runner.ckpt.save)

    def events():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        return ev

    def timed_apply(*a, **kw):
        ev = events()
        out = real_apply(*a, **kw)
        ev[1].record()
        opt_ev.append(ev)
        return out

    def timed_make(*a, **kw):
        step = real_make(*a, **kw)

        def timed_step(lm, state, batch):
            ev = events()
            out = step(lm, state, batch)
            ev[1].record()
            step_ev.append(ev)
            return out
        return timed_step

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        real_save(*a, **kw)
        save_s.append(time.perf_counter() - t0)

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        with mock.patch.object(mod, "make_train_step", timed_make), \
                mock.patch.object(opt, "apply_updates", timed_apply), \
                mock.patch.object(runner.ckpt, "save", timed_save):
            try:
                (lm, state, rep), lines, wall = captured(mod.main, argv)
            except AssertionError as e:
                require(False, f"train_lm at 100M: {e}")
        c = launches["example_train_lm"] = counts()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in lm.parameters())
        require(rep.steps_run == EXAMPLE_TRAIN_STEPS and lines[-1] == "OK"
                and all(math.isfinite(x) for x in rep.losses),
                f"train_lm at 100M: {rep.steps_run} steps, last line "
                f"{lines[-1]!r}")
        require(len(save_s) == 3 and sorted(os.listdir(tmp.name)) == [
            "step_0000000100", "step_0000000150"],
            f"train_lm at 100M: {len(save_s)} saves, kept "
            f"{sorted(os.listdir(tmp.name))}")
        require(not any(c.values()), f"train_lm launched {c}")
        step_ms = [a.elapsed_time(b) for a, b in step_ev]
        opt_ms = [a.elapsed_time(b) for a, b in opt_ev]
        med = statistics.median(step_ms[10:])
        med_opt = statistics.median(opt_ms[10:])
        tokens_s = EXAMPLE_TRAIN_BATCH * EXAMPLE_TRAIN_SEQ / (med / 1e3)
        # an f32 model with TF32 off: its products run at the FP32 peak
        bounds = train_bounds(cfg, n_params, EXAMPLE_TRAIN_BATCH,
                              EXAMPLE_TRAIN_SEQ, peaks, peaks[0], passes=3)
        smi = smi_line(0)
        print("example train_lm on the card:\n" + "\n".join(lines), flush=True)
        print(f"train_lm {cfg.name} ({n_params} parameters, f32, no remat, "
              f"batch {EXAMPLE_TRAIN_BATCH} x {EXAMPLE_TRAIN_SEQ}) on {smi}: "
              f"step {med:.3f} ms (median of steps 11-{EXAMPLE_TRAIN_STEPS}, "
              f"CUDA events; min {min(step_ms[10:]):.3f}, max "
              f"{max(step_ms[10:]):.3f}; step 1 {step_ms[0]:.3f}), "
              f"{tokens_s:.1f} tokens/s; AdamW {med_opt:.3f} ms, "
              f"{med_opt / med:.3f} of a step; peak memory {peak} bytes "
              f"({peak / 2**30:.2f} GiB); checkpoints "
              f"{[round(x, 3) for x in save_s]} s; {wall:.3f} s in all; bound "
              f"{bounds['bound_ms']:.3f} ms ({bounds['bound_by']}: "
              f"{bounds['flops']:.4g} FLOP at the FP32 peak "
              f"{bounds['ops_ms']:.3f} ms, {bounds['bytes']:.4g} bytes "
              f"{bounds['bytes_ms']:.3f} ms), {bounds['bound_ms'] / med:.3f} "
              f"of the step; losses {rep.losses[0]:.4f} -> "
              f"{rep.losses[-1]:.4f}", flush=True)
        # one more step under the profiler: the card's busy time against
        # the wall time
        batch = {k: torch.from_numpy(v).to(lm.device, torch.long) for k, v in
                 mod.TokenPipeline(mod.DataConfig(
                     vocab=cfg.vocab, seq_len=EXAMPLE_TRAIN_SEQ,
                     global_batch=EXAMPLE_TRAIN_BATCH, seed=0)).batch(
                         EXAMPLE_TRAIN_STEPS).items()}
        step = real_make(lm, opt.OptimizerConfig(total_steps=EXAMPLE_TRAIN_STEPS))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(lm, state, batch)[2]["loss"])
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kern)
        profile = {"wall_us": wall_us, "device_busy_us": busy_us,
                   "idle_share": 1 - busy_us / wall_us,
                   "kernels": sum(e.count for e in kern)}
        print(f"train_lm step under the profiler: wall {wall_us:.0f} us, "
              f"device busy {busy_us:.0f} us (idle share "
              f"{profile['idle_share']:.3f}), {profile['kernels']} kernels",
              flush=True)
        del lm, state, step, batch
        torch.cuda.empty_cache()
        (_, _, again), again_lines, again_s = captured(mod.main, argv)
        require(again.steps_run == 0 and "resumed from step 150" in again_lines,
                f"train_lm's second call: {again.steps_run} steps, "
                f"{again_lines}")
        print(f"train_lm second call on the same --ckpt, {again_s:.3f} s: "
              f"{again_lines[1:]}", flush=True)
    finally:
        tmp.cleanup()
    torch.cuda.empty_cache()
    return {"card": smi, "parameters": n_params, "step_ms": step_ms,
            "step_ms_median": med, "tokens_per_s": tokens_s,
            "adamw_ms_median": med_opt, "peak_bytes": peak,
            "checkpoint_s": save_s, "wall_s": wall, "resume_s": again_s,
            "profile": profile,
            "losses": rep.losses, "bounds": bounds, "lines": lines,
            "launches": c}


def examples(dev, peaks, report, launches) -> None:
    """Step 15: the four examples in this process on the card."""
    report["examples"] = {
        "quickstart": example_quickstart(dev, launches),
        "cloud_tuning": example_cloud_tuning(launches),
        "rag_serving": example_rag(launches),
        "train_lm": example_train(peaks, launches)}


if __name__ == "__main__":
    sys.exit(main())
