"""Nothing of the benchmark loads JAX or the JAX package, and the yardstick
loads nothing of the port."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from conftest import ROOT, TINY

REFUSED = {"jax", "jaxlib", "flax", "repro"}
# the driver modules that bring in the system under test (tests may too)
PORT_OK = {"run.py", "system.py", "control.py"}
VS = ROOT / "vsbench"


def top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(VS.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_imports(f) & REFUSED, f


def test_the_yardstick_imports_nothing_of_the_port():
    for f in sorted(VS.rglob("*.py")):
        rel = f.relative_to(VS)
        if rel.parts[0] == "tests" or rel.name in PORT_OK:
            continue
        assert "repro_torch" not in top_imports(f), rel


def test_a_run_loads_no_refused_module(tmp_path):
    """A whole run on the CPU at a tiny size, in a process of its own."""
    from conftest import make_root
    root = make_root(tmp_path / "root")
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]
        import torch
        from vsbench import harness
        from vsbench.system import Program
        cell = harness.load_cell(harness.Path({str(root)!r}), {TINY!r})
        out = harness.run(harness.Path({str(root)!r}), cell, 7, 0.2, False,
                          torch.device("cpu"), Program(), time.perf_counter())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {sorted(REFUSED)!r})
        print(json.dumps({{"correct": out["correct"], "bad": bad,
                          "port": "repro_torch" in sys.modules}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert got == {"correct": True, "bad": [], "port": True}


def _run_py(checkout: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "vsbench/run.py", "--workload",
         "random-s-100.b500.np16", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=checkout,
        env=env)


def test_without_a_card_no_result():
    res = _run_py(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(VS, tmp_path / "vsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
