"""A new cell, configuration, traffic mix and per-layer metric come as new
files: the harness finds each by the name BENCHMARK.json gives it."""
import hashlib
import json
import time

import torch

from conftest import ROOT, TINY
from vsbench import harness
from vsbench.system import Program


def digests(root):
    files = [p for p in (root / "vsbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts
             and "tests" not in p.parts]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files}


def test_a_new_cell_is_resolved_by_name(tiny_root):
    before = digests(ROOT)
    after = digests(tiny_root)
    assert all(after[f] == h for f, h in before.items())
    added = sorted(set(after) - set(before))
    assert added == ["vsbench/checks/tiny.b64.np8.json",
                     "vsbench/configs/tiny.json", "vsbench/traffic/tiny.json"]
    cell = harness.load_cell(tiny_root, TINY)
    assert cell.config["name"] == "tiny" and cell.config["n_samples"] == 3256
    assert cell.traffic["batch"] == 64 and cell.traffic["nprobe"] == 8
    assert [m["name"] for m in cell.metrics["end_to_end"]] == [
        "queries_per_s", "recall_at_10", "setup_s"]


def test_a_new_metric_is_a_new_file(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "batches_a_walk", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "client",
        "moves": "queries_per_s", "workloads": [TINY]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "vsbench" / "metrics" / "batches_a_walk.py").write_text(
        "def read(rec):\n    return len(set(rec.slots.tolist()))\n")
    cell = harness.load_cell(tiny_root, TINY)
    out = harness.run(tiny_root, cell, 11, 0.2, True, torch.device("cpu"),
                      Program(), time.perf_counter())
    assert out["correct"]
    # 256 queries in batches of 64; the device metrics have no trace to
    # read on the CPU and are left out
    assert out["metrics"] == {
        "index_build_s": {"value": out["metrics"]["index_build_s"]["value"],
                          "unit": "s"},
        "batches_a_walk": {"value": 4, "unit": "batches"}}
    assert list(out)[-1] == "checks"
