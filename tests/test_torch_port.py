"""Rules of the port as a whole: it (its examples included) imports neither
JAX nor ``repro``, and its entry points refuse to run on the CPU unless
asked to."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.cluster_index import ClusterIndex  # noqa: E402
from repro_torch.core.flat import exact_topk  # noqa: E402
from repro_torch.core.graph_index import GraphIndex  # noqa: E402
from repro_torch.core.pq import train_pq  # noqa: E402
from repro_torch.core.types import (ClusterIndexParams,  # noqa: E402
                                    GraphIndexParams)
from repro_torch.exec import batched_topk, measure_table  # noqa: E402
from repro_torch.fleet.__main__ import main as fleet_main  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)"
    r"|import\s+.*\b(jax|repro)\b(?!_))", re.M)


def test_port_imports_neither_jax_nor_repro():
    assert len(PORT_FILES) > 10
    hits = []
    for path in PORT_FILES:
        for m in FORBIDDEN.finditer(path.read_text()):
            hits.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not hits, hits


def test_import_scan_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.core import kmeans", "import repro.core.types",
                "  from repro import x"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from repro_torch.core import kmeans", "import repro_torch",
               "import numpy as np", "# the reference uses jax.lax.top_k"):
        assert not FORBIDDEN.search(ok), ok


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    x = np.zeros((40, 8), np.float32)
    with pytest.raises(RuntimeError):
        exact_topk(x, x[:2], 3)
    with pytest.raises(RuntimeError):
        batched_topk(x[:2], x, 3)
    with pytest.raises(RuntimeError):
        ClusterIndex.build(x, ClusterIndexParams(seed=0))
    with pytest.raises(RuntimeError):
        GraphIndex.build(x, GraphIndexParams(R=4, L_build=8, pq_dims=4))
    with pytest.raises(RuntimeError):
        train_pq(x, 4)
    with pytest.raises(RuntimeError):
        measure_table(quick=True)
    # the fleet CLI builds its index on the card unless told --device cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_main(["--n", "40", "--dim", "8", "--queries", "2"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_exits_nonzero_without_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the smoke would run for real")
    # alone in a directory, without the repository beside it
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_library_name_tracks_sources_and_headers():
    names = {_build._lib_path(n).name for n in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    for n in _build.SOURCES:
        assert (_build.CSRC / f"{n}.cu").exists()
        assert _build._lib_path(n).parent == _build.BUILD_DIR
