"""The decoder stack: one module per layer.

Counterpart of ``repro.models.transformer``.  The reference stacks the
parameters of a repeating unit of layers along a leading axis and scans
over it (dense: [attn]; mamba2: [ssm]; recurrentgemma: [rglru, rglru,
attn] with a 2-layer tail; vlm: [attn x4, cross]).  Here the stack is a
``ModuleList`` of every layer in order: layer ``r * len(unit) + j`` is the
reference's unit slot ``j`` at repetition ``r``, and the tail follows.
``stack_forward`` runs the layers a unit repetition at a time; with
``cfg.remat`` each repetition is checkpointed (recomputed in the backward,
under ``REMAT_POLICY``), as the reference's scan body is under
``jax.checkpoint``.

Serving caches are a list with one entry per layer: ``(k, v)`` for an
attention or cross layer, ``{"state", "conv"}`` for SSM and ``{"h",
"conv"}`` for RG-LRU.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MLP, Attention, MoE, attention,
                                       attention_decode, attention_prefill,
                                       cross_attention,
                                       cross_attention_decode_delta, cross_kv,
                                       mlp, moe, remat, ring_window)


# --------------------------------------------------------------- structure

def layer_kinds(cfg: ModelConfig) -> list[str]:
    return [cfg.layer_kind(i) for i in range(cfg.n_layers)]


def unit_structure(cfg: ModelConfig) -> tuple[list[str], int, list[str]]:
    """(unit kinds, n_repetitions, tail kinds)."""
    kinds = layer_kinds(cfg)
    if cfg.block_pattern:
        unit = list(cfg.block_pattern)
    elif cfg.cross_attn_period:
        unit = kinds[: cfg.cross_attn_period]
    else:
        unit = kinds[:1]
    n_rep = len(kinds) // len(unit)
    tail = kinds[n_rep * len(unit):]
    return unit, n_rep, tail


def attention_window(cfg: ModelConfig) -> int:
    """The local window of the self-attention layers (0: global)."""
    return cfg.local_window if cfg.block_pattern else 0


# ------------------------------------------------------------------ layers

class Block(nn.Module):
    """One layer; its submodules carry the reference's parameter names."""

    def __init__(self, cfg: ModelConfig, kind: str, gen, device=None):
        super().__init__()
        self.kind = kind
        if kind == "ssm":
            self.ssm = ssm_mod.SSM(cfg, gen, device)
        elif kind == "rglru":
            self.rec = rg.RGLRU(cfg, gen, device)
            self.ffn = MLP(cfg, gen, device=device)
        elif kind == "cross":
            self.attn = Attention(cfg, gen, cross=True, device=device)
            self.ffn = MLP(cfg, gen, device=device)
        else:
            self.attn = Attention(cfg, gen, device=device)
            self.ffn = (MoE(cfg, gen, device) if cfg.n_experts
                        else MLP(cfg, gen, device=device))


def _ffn(p: Block, cfg: ModelConfig, x):
    return (moe if cfg.n_experts else mlp)(p.ffn, cfg, x)


def _apply_block(p: Block, cfg: ModelConfig, x, positions, ctx):
    kind = p.kind
    if kind == "ssm":
        return ssm_mod.ssm_forward(p.ssm, cfg, x)
    if kind == "rglru":
        x = rg.rglru_forward(p.rec, cfg, x)
        return mlp(p.ffn, cfg, x)
    if kind == "cross":
        x = cross_attention(p.attn, cfg, x, ctx)
        return mlp(p.ffn, cfg, x)
    x = attention(p.attn, cfg, x, positions, window=attention_window(cfg))
    return _ffn(p, cfg, x)


# Optional remat policy for the unit checkpoint (a training knob):
# None = full recompute of each unit in the backward;
# "dots" = save the outputs of the products without batch dims (those with
# the weights: aten ``mm``/``addmm``, and ``bmm`` over a batch of 1, which is
# how ``einsum`` runs them), recompute the rest.  Attention's score and PV
# products run as a ``bmm`` over (batch x kv-heads), so they are recomputed,
# unless that is 1 (batch 1 of an MQA arch), when they are saved too.
REMAT_POLICY: str | None = None


def set_remat_policy(name: str | None) -> None:
    global REMAT_POLICY
    if name not in (None, "dots"):
        raise ValueError(f"unknown remat policy {name!r}")
    REMAT_POLICY = name


def _save_dots(ctx, func, *args, **kwargs):
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.addmm.default) or (
            func is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _policy() -> dict:
    if REMAT_POLICY == "dots":
        return {"context_fn": lambda: create_selective_checkpoint_contexts(
            _save_dots)}
    return {}


def stack_forward(blocks, cfg: ModelConfig, x, positions, ctx=None,
                  apply=_apply_block):
    """The layers in order, a unit repetition at a time (the reference's
    scan); with ``cfg.remat`` each repetition is checkpointed, the tail
    layers are not.  ``apply(block, cfg, x, positions, ctx)`` runs one
    layer (the sharded path passes its own)."""
    unit, n_rep, _ = unit_structure(cfg)
    u = len(unit)

    def unit_fn(h, r):
        for p in blocks[r * u:(r + 1) * u]:
            h = apply(p, cfg, h, positions, ctx)
        return h

    for r in range(n_rep):
        x = remat(unit_fn, x, r, **_policy()) if cfg.remat else unit_fn(x, r)
    for p in blocks[n_rep * u:]:
        x = apply(p, cfg, x, positions, ctx)
    return x


# ------------------------------------------------------------- serving ---

def _block_prefill(p: Block, cfg: ModelConfig, x, positions, ctx):
    kind = p.kind
    if kind == "ssm":
        return ssm_mod.ssm_prefill(p.ssm, cfg, x)
    if kind == "rglru":
        x, cache = rg.rglru_prefill(p.rec, cfg, x)
        return mlp(p.ffn, cfg, x), cache
    if kind == "cross":
        x = cross_attention(p.attn, cfg, x, ctx)
        return mlp(p.ffn, cfg, x), cross_kv(p.attn, cfg, ctx)
    window = attention_window(cfg)
    x, (k, v) = attention_prefill(p.attn, cfg, x, positions, window=window)
    return _ffn(p, cfg, x), ring_window(k, v, window)


def _block_decode(p: Block, cfg: ModelConfig, x, pos: int, cache, ctx):
    kind = p.kind
    if kind == "ssm":
        return ssm_mod.ssm_decode(p.ssm, cfg, x, cache)
    if kind == "rglru":
        x, cache = rg.rglru_decode(p.rec, cfg, x, cache)
        return mlp(p.ffn, cfg, x), cache
    if kind == "cross":
        x = x + cross_attention_decode_delta(p.attn, cfg, x, *cache)
        return mlp(p.ffn, cfg, x), cache
    x, cache = attention_decode(p.attn, cfg, x, cache, pos,
                                window=attention_window(cfg))
    return _ffn(p, cfg, x), cache


def stack_prefill(blocks, cfg: ModelConfig, x, positions, ctx=None):
    caches = []
    for p in blocks:
        x, c = _block_prefill(p, cfg, x, positions, ctx)
        caches.append(c)
    return x, caches


def stack_decode(blocks, cfg: ModelConfig, x, pos: int, caches, ctx=None):
    new = []
    for p, c in zip(blocks, caches):
        x, nc = _block_decode(p, cfg, x, pos, c, ctx)
        new.append(nc)
    return x, new
