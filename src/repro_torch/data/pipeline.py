"""Deterministic, resumable LM token pipeline.

Training at scale needs a data source that (a) is reproducible across
restarts, (b) can seek to an arbitrary step (checkpoint resume without
replaying), and (c) shards across data-parallel workers without overlap.
This synthetic pipeline (a fixed-vocab Zipf-mixture "language" with local
n-gram structure so models actually have something to learn) provides all
three; a file-backed source can implement the same interface.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 512      # latent bigram patterns (learnable signal)


class TokenPipeline:
    """``batch(step)`` is a pure function of (config, step) — resumable
    and shardable by construction."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # latent bigram table: each token prefers a successor set
        self.succ = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, 4)).astype(np.int32)

    def batch(self, step: int, worker: int = 0, n_workers: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % n_workers == 0
        b = cfg.global_batch // n_workers
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + worker)
        toks = np.empty((b, cfg.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        follow = rng.random((b, cfg.seq_len)) < 0.8
        choice = rng.integers(0, 4, size=(b, cfg.seq_len))
        noise = rng.integers(0, cfg.vocab, size=(b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self.succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
