"""The benchmark's driver: it resolves a cell of ``BENCHMARK.json`` to its
files, drives the system under test through set-up and the measured
window, judges the answers against the plain reference, and reads the
metrics.

Nothing here imports the port: the system under test is an object with
``prepare(device)``, ``build(data, params, device) -> state``,
``search(state, queries, nprobe, k) -> (ids, dists)`` and
``lists(state) -> {"centroids", "list_ids", "list_len"}`` (the index it
searched, as host arrays), which ``run.py`` makes from ``repro_torch``
(``system.py``) and the control script from the reference.  A cell is found by name: its configuration is the file that
``BENCHMARK.json`` names, its traffic ``traffic/<traffic>.json``, its limits
``checks/<cell>.json`` and each metric ``metrics/<metric>.py``, whose
``read(record)`` returns the number or ``None`` when there is nothing to
read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vsbench import check, datagen, devtrace, loadgen, work
from vsbench.reference import search as ref

WARM_S = 0.5        # seconds of batches before the window: clocks settle


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: dict                # "end_to_end" / "per_layer" -> [entry]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work_ = {w["name"]: w for w in bench["workloads"]}
    if name not in work_:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work_)}")
    w = work_[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "vsbench"
    metrics = {kind: [m for m in bench[kind]
                      if name in m.get("workloads", [name])]
               for kind in ("end_to_end", "per_layer")}
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / "checks" / f"{name}.json").read_text()),
        metrics=metrics)


def load_reader(root: Path, metric: str):
    """``read`` of ``vsbench/metrics/<metric>.py``."""
    path = root / "vsbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"vsbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


INDEX_KEYS = ("centroid_frac", "num_replica", "closure_eps", "kmeans_iters",
              "branch", "balance_penalty")


def index_params(cfg: dict) -> dict:
    """The cluster index's build parameters a configuration file states."""
    return {**{key: cfg[key] for key in INDEX_KEYS}, "seed": cfg["index_seed"]}


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""
    cell: Cell
    device: torch.device
    card: str                    # torch.cuda.get_device_name(), or "cpu"
    setup_s: float
    spans: dict                  # host-clock spans of set-up, seconds
    window_s: float              # host clock, first send to last answer
    latencies: np.ndarray        # (batches,) seconds from send to answer
    slots: np.ndarray            # (batches,) first pool row of each batch
    batch: int
    verdict: check.Verdict
    shapes: dict                 # n_lists, dim, max_len, entries
    batch_work: dict             # slot -> (FLOP, bytes) the search needs
    trace: devtrace.Trace | None

    @property
    def queries(self) -> int:
        return len(self.slots) * self.batch


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Window:
    """What the measured window sent and got back."""
    seconds: float               # host clock, first send to last answer
    latencies: np.ndarray        # (batches,) seconds from send to answer
    slots: np.ndarray            # (batches,) first pool row of each batch
    ids: np.ndarray              # (batches, batch, k) answers on the host
    dists: np.ndarray
    trace: devtrace.Trace | None


def serve(system, state, pool: np.ndarray, gen: loadgen.ClosedLoop,
          seconds: float, device: torch.device, traced: bool,
          on_start=None) -> Window:
    """Warm up for a walk of the pool and ``WARM_S``, then run the closed
    loop for ``seconds`` (and at least one walk of the pool).  The client
    sends from pinned memory and receives into pinned buffers, as a
    batch-retrieval client does.  ``on_start(t)`` is called as the first
    timed batch is sent."""
    cuda = device.type == "cuda"
    pool_h = torch.from_numpy(pool)
    if cuda:
        pool_h = pool_h.pin_memory()
    recv: list[torch.Tensor] = []

    def one(b: int, rf):
        rows = gen.rows(b)
        with rf("vsbench.send"):
            q = pool_h[rows].to(device, non_blocking=True)
        with rf("vsbench.search"):
            out = system.search(state, q, gen.nprobe, gen.k)
        with rf("vsbench.receive"):
            if not recv:
                recv.extend(torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                            for t in out)
            for h, t in zip(recv, out):
                h.copy_(t, non_blocking=True)
            if cuda:
                torch.cuda.current_stream(device).synchronize()
            return recv[0].numpy().copy(), recv[1].numpy().copy()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the client is one thread: no pool's jitter
    t_warm = time.perf_counter()
    b = 0
    while b < gen.slots or time.perf_counter() - t_warm < WARM_S:
        one(b, _no_range)
        b += 1
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    rf = torch.profiler.record_function if traced else _no_range
    lat, slots, out_ids, out_d = [], [], [], []
    b = 0
    gc.collect()
    gc.disable()                 # no collector pauses inside the window
    t_start = time.perf_counter()
    if on_start is not None:
        on_start(t_start)
    with rf(devtrace.WINDOW):
        while True:
            t_send = time.perf_counter()
            ids, d = one(b, rf)
            t_done = time.perf_counter()
            lat.append(t_done - t_send)
            out_ids.append(ids)
            out_d.append(d)
            b += 1
            if t_done - t_start >= seconds and b >= gen.slots:
                break
    gc.enable()
    torch.set_num_threads(threads)
    tr = None
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        t_exit = time.perf_counter()
        if cuda:
            tr = devtrace.reduce(devtrace.read(prof))
        _log(f"vsbench: trace: profiler stop {t_exit - t:.3f} s, reduce "
             f"{time.perf_counter() - t_exit:.3f} s")
    slots = np.array([gen.rows(i).start for i in range(b)])
    return Window(t_done - t_start, np.array(lat), slots,
                  np.stack(out_ids), np.stack(out_d), tr)


@dataclasses.dataclass
class Reference:
    """The plain reference's answers to every pool query, over the lists it
    works out from the program's centroids."""
    ids: np.ndarray              # (P, k) its search's answers
    gt: np.ndarray               # (P, k) exact nearest ids
    probed: np.ndarray           # (P, nprobe) lists each query probes
    lengths: np.ndarray          # (L,) unpadded list lengths
    index: ref.Index
    n: int                       # points in the data

    def batch_work(self, slots: np.ndarray, batch: int, dim: int, k: int
                   ) -> dict:
        """First pool row -> (FLOP, bytes) of that batch's search."""
        return {int(s): work.search_batch_work(
            self.probed[s:s + batch], self.lengths, len(self.lengths), dim, k)
            for s in np.unique(slots)}

    def lists_differ(self, built: dict) -> tuple[float, float]:
        """``(lists_differ, unsure share)`` of the lists ``built``."""
        return ref.lists_differ(self.index, built["list_ids"],
                                built["list_len"], self.n)


def reference(data: np.ndarray, pool: np.ndarray, centroids: np.ndarray,
              params: dict, gen: loadgen.ClosedLoop, device: torch.device
              ) -> Reference:
    """The reference's lists over ``centroids`` and its answers."""
    xd = torch.from_numpy(data).to(device)
    qd = torch.from_numpy(pool).to(device)
    index = ref.build_index(xd, torch.from_numpy(centroids).to(device), params)
    ids, _, probed = ref.search(index, xd, qd, gen.nprobe, gen.k)
    return Reference(ids.cpu().numpy(), ref.exact_topk(xd, qd, gen.k),
                     probed.cpu().numpy(), index.lengths.cpu().numpy(), index,
                     len(data))


def run(root: Path, cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, system, t0: float) -> dict:
    """One run of ``cell``: the result line's object.  ``t0`` is the
    process's start on ``time.perf_counter()``'s clock."""
    spec = datagen.spec_from_config(cell.config)
    params = index_params(cell.config)
    system.prepare(device)
    data, pool = datagen.make(spec, seed)
    gen = loadgen.generator(cell.traffic, len(pool))
    _log(f"vsbench: {cell.name} seed {seed}: data {data.shape} "
         f"{data.dtype}, pool {pool.shape}, {gen.slots} batches a walk")
    if device.type == "cuda":
        torch.empty(0, device=device)      # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    state = system.build(data, params, device)
    _sync(device)
    spans = {"index_build_s": time.perf_counter() - t}
    _log(f"vsbench: index {json.dumps(state['shapes'])} in "
         f"{spans['index_build_s']:.3f} s")
    started = []
    win = serve(system, state, pool, gen, seconds, device, traced,
                started.append)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    _log(f"vsbench: window {win.seconds:.6f} s, {len(win.slots)} batches, "
         f"peak {peak} bytes")
    shapes = state["shapes"]
    built = system.lists(state)
    del state                    # before the reference runs on the device
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    rf = reference(data, pool, built["centroids"], params, gen, device)
    ref_s = time.perf_counter() - t
    lists, unsure = rf.lists_differ(built)
    verdict = check.judge(win.slots, win.ids, win.dists, pool, data, rf.ids,
                          rf.gt, gen.batch, cell.limits, lists)
    _log(f"vsbench: reference {ref_s:.3f} s, check "
         f"{time.perf_counter() - t - ref_s:.3f} s; recall "
         f"{verdict.recall!r}; malformed answers {verdict.why_bad}; points "
         f"on a near-tie of the closure {unsure!r}")

    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec = Record(cell=cell, device=device, card=card,
                 setup_s=started[0] - t0, spans=spans, window_s=win.seconds,
                 latencies=win.latencies, slots=win.slots, batch=gen.batch,
                 verdict=verdict, shapes=shapes,
                 batch_work=rf.batch_work(win.slots, gen.batch,
                                          data.shape[1], gen.k),
                 trace=win.trace)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = load_reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": verdict.correct, "attempted": verdict.answers,
           "failed": verdict.values["malformed"], "metrics": metrics, "device": dev}
    if win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        out["breakdown"] = {"device_ops": win.trace.device_ops,
                            "idle_gaps": win.trace.idle_gaps}
    out["checks"] = verdict.record()
    return out


@contextlib.contextmanager
def _no_range(name: str):
    yield
