"""Run manifests: make every report/bench JSON self-describing.

A manifest pins down what produced a payload — git revision, RNG seed,
a content hash of the effective config, wall-clock cost and the exact
command line — so a BENCH_*.json entry or a trace file found on a CI
artifact shelf can be traced back to a reproducible run.

The port's own copy of ``repro.obs.manifest``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

__all__ = ["git_sha", "config_hash", "run_manifest"]


def git_sha() -> str:
    """Short git revision of the working tree, or ``"unknown"``."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_hash(config) -> str:
    """Short content hash of a JSON-able config mapping."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def run_manifest(*, seed: int | None = None, config=None,
                 argv: list[str] | None = None,
                 wall_s: float | None = None) -> dict:
    """Build the ``meta`` block for a report/bench payload."""
    if argv is None:
        argv = sys.argv
    meta = dict(
        git_sha=git_sha(),
        timestamp=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        command=" ".join(argv),
        python=sys.version.split()[0],
    )
    if seed is not None:
        meta["seed"] = int(seed)
    if config is not None:
        meta["config_hash"] = config_hash(config)
    if wall_s is not None:
        meta["wall_s"] = round(wall_s, 3)
    return meta
