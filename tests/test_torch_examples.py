"""The port's examples (``examples/torch/``) against the reference's
(``examples/``), each run in this process on the same inputs.

* ``quickstart.py``: both indexes at 4,000 x 96, served over TOS, and the
  cost model; a port-built index equals the reference's, so every printed
  line (virtual time, recall, sizes) is the reference's;
* ``cloud_tuning.py``: the analytic screen over four workloads x two
  environments, with and without a cache; the same lines;
* each example, with ``--device`` left at its default, raises without a
  card instead of running on the CPU.

The LM examples are in ``tests/test_torch_examples_lm.py``.
"""
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "cloud_tuning", "rag_serving", "train_lm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the quickstart's graph build is as fast on one,
    and several contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_example(name: str, port: bool):
    """``examples/[torch/]<name>.py`` as a module of its own name (both
    files are called ``<name>.py``)."""
    path = ROOT / "examples" / ("torch" if port else "") / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{'port' if port else 'ref'}_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue().splitlines()


def ref_lines(name: str, argv: list[str], monkeypatch) -> list[str]:
    """The reference example's lines: its ``main`` reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return printed(load_example(name, port=False).main)


def test_quickstart_prints_the_reference_lines(monkeypatch):
    want = ref_lines("quickstart", [], monkeypatch)
    got = printed(load_example("quickstart", port=True).main,
                  ["--device", "cpu"])
    assert len(want) == 13 and "872 posting lists" in want[2]
    assert got == want


@pytest.mark.parametrize("argv", [[], ["--cache-gb", "4"]],
                         ids=["no-cache", "cache-4gb"])
def test_cloud_tuning_screen_prints_the_reference_lines(argv, monkeypatch):
    want = ref_lines("cloud_tuning", argv, monkeypatch)
    got = printed(load_example("cloud_tuning", port=True).main,
                  [*argv, "--device", "cpu"])
    assert sum("predicted:" in ln for ln in want) == 8
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_the_card_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    main = load_example(name, port=True).main
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(
            RuntimeError, match="device='cpu'"):
        main(["--quick", "--steps", "1"] if name == "train_lm" else [])
    assert out.getvalue() == ""        # nothing ran before the check
