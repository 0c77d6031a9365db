"""The benchmark's driver: it resolves a cell of ``BENCHMARK.json`` to its
files, drives the system under test through set-up and the measured
window, judges the answers against the plain reference, and reads the
metrics.

A cell is found by name: its configuration is the file that
``BENCHMARK.json`` names, its traffic ``traffic/<traffic>.json``, its limits
``checks/<cell>.json`` and each metric ``metrics/<metric>.py``, whose
``read(record)`` returns the number or ``None`` when there is nothing to
read.  The configuration's ``"index"`` names its index kind (``kinds/``:
``spann`` where absent), which brings the build parameters, the traffic's
knobs, the system under test, the plain reference with its own compared
numbers, and each batch's work; a new kind is new files there
(``vsbench/kinds/__init__.py`` sets them out).

Nothing here imports the port: the system under test is a ``Program`` as
``vsbench/system.py`` sets out, which ``run.py`` makes from the kind's
``system.py`` and the control script from the reference.  In the traced
run of a cell with a per-layer metric whose source is ``program_span`` or
``program_counter``, the program's recorder is on from before the build:
the record keeps its snapshot of the build, its snapshot of the window
(reset as the first timed batch is sent) and the window's trace events,
for ``vsbench.stages``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vsbench import check, datagen, devtrace, kinds, loadgen

WARM_S = 0.5        # seconds of batches before the window: clocks settle
ROOT = Path(__file__).resolve().parents[1]
PROGRAM_SOURCES = ("program_span", "program_counter")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: dict                # "end_to_end" / "per_layer" -> [entry]
    kind: kinds.Kind


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files and its
    index kind; raises where its limits are not its numbers'."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work_ = {w["name"]: w for w in bench["workloads"]}
    if name not in work_:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work_)}")
    w = work_[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "vsbench"
    metrics = {part: [m for m in bench[part]
                      if name in m.get("workloads", [name])]
               for part in ("end_to_end", "per_layer")}
    config = json.loads((root / conf["file"]).read_text())
    kind = kinds.load(root, kinds.index_of(config))
    limits = json.loads((here / "checks" / f"{name}.json").read_text())
    check.require((*check.GENERIC, *kind.numbers), limits)
    return Cell(
        name=name, chips=w["chips"], config=config,
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=limits, metrics=metrics, kind=kind)


def load_reader(root: Path, metric: str):
    """``read`` of ``vsbench/metrics/<metric>.py``."""
    return kinds.load_module(root / "vsbench" / "metrics" / f"{metric}.py",
                             f"vsbench_metric_{metric}").read


def index_params(cfg: dict) -> dict:
    """The build parameters a configuration file states, by its kind (the
    call of ``tools/trace_stages.py`` and ``tools/ab_search.py``)."""
    return kinds.load(ROOT, kinds.index_of(cfg)).params(cfg)


def reference(data, pool, centroids, params, gen, device):
    """SPANN's reference over the program's ``centroids``
    (``kinds/spann/reference.py``'s ``over_centroids``), as
    ``tools/trace_stages.py`` calls it."""
    spann = kinds.load_module(ROOT / "vsbench" / "kinds" / "spann"
                              / "reference.py", "vsbench_kind_spann_reference")
    return spann.over_centroids(data, pool, centroids, params, gen, device)


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
    shapes: dict                 # the state's "shapes": the index's sizes
    batch_work: dict             # slot -> (FLOP, bytes) the search needs
    trace: devtrace.Trace | None
    # the program's recorder, where a per-layer metric reads it
    build_snapshot: dict | None = None     # after the build
    window_snapshot: dict | None = None    # of the window's batches
    events: list | None = None             # the traced window's events

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
    events: list | None          # the trace's events, where kept


def serve(system, state, pool: np.ndarray, gen: loadgen.ClosedLoop,
          seconds: float, device: torch.device, traced: bool,
          on_start=None, keep_events: bool = False) -> Window:
    """Warm up for a walk of the pool and ``WARM_S``, then run the closed
    loop for ``seconds`` (and at least one walk of the pool).  The client
    sends from pinned memory and receives into pinned buffers, as a
    batch-retrieval client does.  ``on_start(t)`` is called as the first
    timed batch is sent.  A traced window keeps its trace's events where
    ``keep_events``."""
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
            out = system.search(state, q, k=gen.k, **gen.knobs)
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
    tr = events = None
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        t_exit = time.perf_counter()
        if cuda or keep_events:
            events = devtrace.read(prof)
        if cuda:
            tr = devtrace.reduce(events)
        _log(f"vsbench: trace: profiler stop {t_exit - t:.3f} s, reduce "
             f"{time.perf_counter() - t_exit:.3f} s")
    slots = np.array([gen.rows(i).start for i in range(b)])
    return Window(t_done - t_start, np.array(lat), slots,
                  np.stack(out_ids), np.stack(out_d), tr,
                  events if keep_events else None)


def run(root: Path, cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, system, t0: float) -> dict:
    """One run of ``cell``: the result line's object.  ``t0`` is the
    process's start on ``time.perf_counter()``'s clock."""
    kind = cell.kind
    spec = datagen.spec_from_config(cell.config)
    params = kind.params(cell.config)
    system.prepare(device)
    data, pool = datagen.make(spec, seed)
    gen = loadgen.generator(cell.traffic, len(pool), kind.knobs)
    _log(f"vsbench: {cell.name} seed {seed}: data {data.shape} "
         f"{data.dtype}, pool {pool.shape}, {gen.slots} batches a walk")
    if device.type == "cuda":
        torch.empty(0, device=device)      # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    recorder = (traced and hasattr(system, "trace") and any(
        m["source"] in PROGRAM_SOURCES for m in cell.metrics["per_layer"]))
    if recorder:
        system.trace(True)
    t = time.perf_counter()
    state = system.build(data, params, device)
    _sync(device)
    spans = {"index_build_s": time.perf_counter() - t}
    _log(f"vsbench: index {json.dumps(state['shapes'])} in "
         f"{spans['index_build_s']:.3f} s")
    build_snap = system.snapshot() if recorder else None
    started = []

    def on_start(t_start: float) -> None:
        started.append(t_start)
        if recorder:
            system.trace(True)       # the warm-up's records go
    win = serve(system, state, pool, gen, seconds, device, traced, on_start,
                keep_events=recorder)
    window_snap = None
    if recorder:
        window_snap = system.snapshot()
        system.trace(False)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    _log(f"vsbench: window {win.seconds:.6f} s, {len(win.slots)} batches, "
         f"peak {peak} bytes")
    shapes = state["shapes"]
    built = system.built(state)
    del state                    # before the reference runs on the device
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    rf = kind.reference(data, pool, built, params, gen, device)
    ref_s = time.perf_counter() - t
    verdict = check.judge(win.slots, win.ids, win.dists, pool, data, rf.ids,
                          rf.gt, gen.batch, cell.limits, rf.numbers)
    _log(f"vsbench: reference {ref_s:.3f} s, check "
         f"{time.perf_counter() - t - ref_s:.3f} s; recall "
         f"{verdict.recall!r}; malformed answers {verdict.why_bad}"
         + "".join(f"; {what} {v!r}" for what, v in rf.notes.items()))

    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec = Record(cell=cell, device=device, card=card,
                 setup_s=started[0] - t0, spans=spans, window_s=win.seconds,
                 latencies=win.latencies, slots=win.slots, batch=gen.batch,
                 verdict=verdict, shapes=shapes, batch_work=rf.work,
                 trace=win.trace, build_snapshot=build_snap,
                 window_snapshot=window_snap, events=win.events)
    metrics = {}
    for m in cell.metrics["per_layer" if traced else "end_to_end"]:
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
