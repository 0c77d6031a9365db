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

Sharded trees (DTensor leaves) save and restore on any number of ranks:
every rank calls :func:`save` (a leaf's ``full_tensor()`` is a collective),
rank 0 alone copies each leaf to the host and writes it, and all wait for
it; :func:`restore` gives each rank its own piece of every leaf under the
target leaf's placements.  So a checkpoint written on 4 ranks restores on
1, and the other way round.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _writer() -> bool:
    """Rank 0 of a process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf: torch.Tensor) -> np.ndarray:
    return leaf.detach().cpu().numpy()


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None
         ) -> str:
    """Atomically persist ``tree`` for ``step``, a leaf at a time: one leaf
    is on the host at once.  Returns the step dir.  With several ranks
    every rank calls it (a DTensor leaf's ``full_tensor()`` is a
    collective) and rank 0 alone copies each leaf to the host and writes
    it."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp_dir = step_dir + ".tmp"
    writer = _writer()
    if writer:
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)
    leaves_meta = []
    for name, leaf in _leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if writer:
            arr = _host(leaf)
            np.save(os.path.join(tmp_dir, name + ".npy"), arr)
            leaves_meta.append({"name": name, "shape": list(arr.shape),
                                "dtype": str(arr.dtype)})
            del arr
        del leaf
    if writer:
        manifest = {"step": step, "leaves": leaves_meta,
                    "extra": extra or {}}
        mpath = os.path.join(tmp_dir, MANIFEST)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(mpath + ".tmp", mpath)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.replace(tmp_dir, step_dir)          # atomic publish
    if _ranks() > 1:
        dist.barrier()
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
    one); a DTensor target leaf gives a DTensor under its placements, of
    which this rank holds its piece.  Raises ``KeyError``
    on a leaf the checkpoint lacks and ``ValueError`` on a shape
    mismatch."""
    from repro_torch.models.parallel import place
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
        arr = arr.to(device=dev, dtype=leaf.dtype)
        if isinstance(leaf, DTensor):
            arr = place(arr, leaf.device_mesh, leaf.placements)
        out.append(arr)
    return _rebuild(target, iter(out))


def gc_old(ckpt_dir: str, keep_last: int = 2) -> None:
    if not _writer():
        return
    for s in _complete_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
