"""Fault-tolerant checkpointing with restore onto any device.

Counterpart of ``repro.train.checkpoint``, with its protocol:

* every leaf of a tree (nested dicts, lists and tuples of tensors) is saved
  as its own ``.npy`` under ``step_%010d``, named by its path (keys joined
  by ``__``: ``params__blocks.0.attn.wq``, ``opt__m__embed``,
  ``opt__step``);
* a JSON manifest (step, leaves with name/shape/dtype, extra) is written
  LAST, through a temporary file and ``os.replace``, inside a temporary
  step directory that is then renamed into place, so a torn checkpoint is
  never visible to :func:`latest_step`;
* :func:`restore` loads into the structure and shapes of a *target* tree
  and places each tensor on ``device`` (the reference's ``shardings`` on
  one rank);
* :func:`gc_old` keeps the newest ``keep_last`` complete steps, never
  removing the newest.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

MANIFEST = "manifest.json"


def _leaves(tree: Any, path: tuple = ()):
    """``(name, leaf)`` of every tensor of ``tree``, in order."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (str(i),))
    else:
        name = "__".join(re.sub(r"[^A-Za-z0-9_.-]", "_", p) for p in path)
        yield name or "root", tree


def _rebuild(tree: Any, values) -> Any:
    if isinstance(tree, dict):
        return {key: _rebuild(sub, values) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, values) for sub in tree)
    return next(values)


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None
         ) -> str:
    """Atomically persist ``tree`` for ``step``.  Returns the step dir."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    leaves_meta = []
    for name, leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy()
        np.save(os.path.join(tmp_dir, name + ".npy"), arr)
        leaves_meta.append({"name": name, "shape": list(arr.shape),
                            "dtype": str(arr.dtype)})
    manifest = {"step": step, "leaves": leaves_meta, "extra": extra or {}}
    mpath = os.path.join(tmp_dir, MANIFEST)
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)          # atomic publish
    return step_dir


def _complete_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a COMPLETE manifest (torn writes are ignored)."""
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target: Any,
            device: str | torch.device | None = None) -> Any:
    """Load ``step`` into the structure of ``target`` (a tree of tensors,
    ``meta`` ones included): each leaf takes its target's dtype and goes to
    ``device`` (None: the target leaf's own device, the CPU for a ``meta``
    one).  Raises ``KeyError``
    on a leaf the checkpoint lacks and ``ValueError`` on a shape
    mismatch."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(step_dir, MANIFEST)) as f:
        manifest = json.load(f)
    shapes = {m["name"]: tuple(m["shape"]) for m in manifest["leaves"]}
    out = []
    for name, leaf in _leaves(target):
        if name not in shapes:
            raise KeyError(f"checkpoint missing leaf {name}")
        if shapes[name] != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {shapes[name]} != "
                             f"target {tuple(leaf.shape)}")
        arr = torch.from_numpy(np.load(os.path.join(step_dir,
                                                    name + ".npy")))
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        out.append(arr.to(device=dev, dtype=leaf.dtype))
    return _rebuild(target, iter(out))


def gc_old(ckpt_dir: str, keep_last: int = 2) -> None:
    for s in _complete_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
