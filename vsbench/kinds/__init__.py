"""Index kinds: what of the benchmark belongs to one kind of index, found
by the name that a configuration gives it.

A configuration file's ``"index"`` key names its kind, ``"spann"`` where
the key is absent.  The kind is the directory ``vsbench/kinds/<index>/`` of
the checkout, and a new kind is these new files there, each loaded by its
path (no registry to edit):

``kind.py``
    ``KNOBS``: the names of the search parameters that every request of a
    traffic mix carries beside ``k`` (a traffic file gives each its
    value).  ``NUMBERS``: the names of the kind's own numbers that decide
    ``correct`` beside ``check.GENERIC``; a cell's ``checks/<cell>.json``
    holds a limit for each of both, and no other.  ``params(cfg) -> dict``:
    the index's build parameters as the configuration file states them.
``system.py``
    ``Program``, the system under test, as ``vsbench/system.py`` sets out.
    The only file of a kind that imports the port.
``reference.py``
    ``reference(data, pool, built, params, gen, device) -> Answers``: the
    plain reference, in plain PyTorch or NumPy, importing nothing of the
    port.  ``data`` (n, dim) and ``pool`` (P, dim) are the run's float32
    points and queries, ``built`` is ``Program.built``'s host copy of the
    index the window searched, ``params`` is ``kind.params``' and ``gen``
    the traffic's ``loadgen.ClosedLoop`` (``k``, ``knobs``, ``batch``,
    ``slots``, ``rows``).  It runs once the window has closed and the
    program's state is freed, on the run's device.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path
from typing import Callable

import numpy as np

DEFAULT = "spann"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Answers:
    """What a kind's reference gives the comparison and the work count."""
    ids: np.ndarray              # (P, k) its answer to each pool query
    gt: np.ndarray               # (P, k) each pool query's exact k nearest ids
    work: dict                   # a batch's first pool row -> (FLOP, bytes)
    numbers: dict                # its own numbers compared, by name (NUMBERS)
    notes: dict                  # further readings, logged and not compared


@dataclasses.dataclass(frozen=True)
class Kind:
    name: str
    path: Path                   # vsbench/kinds/<name>/
    knobs: tuple                 # kind.py's KNOBS
    numbers: tuple               # kind.py's NUMBERS
    params: Callable             # kind.py's params(cfg) -> dict
    reference: Callable          # reference.py's reference(...) -> Answers

    def program(self):
        """A new ``Program`` of the kind's ``system.py``: this loads the
        port."""
        return load_module(self.path / "system.py",
                           f"vsbench_kind_{self.name}_system").Program()


def load_module(path: Path, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def index_of(cfg: dict) -> str:
    """The index kind a configuration file names."""
    return cfg.get("index", DEFAULT)


def load(root: Path, name: str) -> Kind:
    """The kind ``name`` of the checkout at ``root``; raises where it has
    none."""
    path = root / "vsbench" / "kinds" / str(name)
    if not NAME.fullmatch(str(name)) or not (path / "kind.py").is_file():
        raise ValueError(f"no index kind {name!r}: {path / 'kind.py'} is "
                         f"missing")
    kind = load_module(path / "kind.py", f"vsbench_kind_{name}_kind")
    ref = load_module(path / "reference.py", f"vsbench_kind_{name}_reference")
    return Kind(name, path, tuple(kind.KNOBS), tuple(kind.NUMBERS),
                kind.params, ref.reference)
