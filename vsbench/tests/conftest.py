"""Tests of the benchmark harness, on the CPU at small sizes.

Run from the repository's root: ``python -m pytest -q vsbench/tests``.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = "tiny.b64.np8"


def make_root(dest: Path, n_samples: int = 3256, dim: int = 32,
              centers: int = 30, n_queries: int = 256, batch: int = 64,
              nprobe: int = 8) -> Path:
    """A copy of ``vsbench/`` and ``BENCHMARK.json`` under ``dest`` with one
    more cell, ``tiny.b64.np8``: new files only, no existing file edited."""
    shutil.copytree(ROOT / "vsbench", dest / "vsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = bench["configs"][0]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    cfg.update(name="tiny", n_samples=n_samples, dim=dim, centers=centers,
               n_queries=n_queries)
    (dest / "vsbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (dest / "vsbench" / "traffic" / "tiny.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": batch, "nprobe": nprobe,
         "k": 10}))
    cell = next(w for w in bench["workloads"] if w["config"] == conf["name"])
    limits = json.loads((ROOT / "vsbench" / "checks" /
                         f"{cell['name']}.json").read_text())
    (dest / "vsbench" / "checks" / f"{TINY}.json").write_text(json.dumps(limits))
    bench["configs"].append({**conf, "name": "tiny",
                             "file": "vsbench/configs/tiny.json"})
    bench["workloads"].append({**cell, "name": TINY,
                               "config": "tiny", "traffic": "tiny"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
