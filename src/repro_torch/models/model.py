"""LM wrapper: embeddings, stack, head, loss and the serving steps.

Counterpart of ``repro.models.model``.  One class serves all 10 assigned
architectures; modality differences are confined to the inputs:

* text archs: int ``tokens``;
* musicgen (audio): the EnCodec frontend is a stub, inputs are
  precomputed frame embeddings ``frames`` (B, S, D);
* llama-3.2-vision (vlm): text tokens plus precomputed patch embeddings
  ``image_embeds`` (B, n_frontend_tokens, D) read by the cross layers.

``LM(cfg, seed)`` draws its parameters from a ``torch.Generator`` seeded
with ``seed`` on the CPU, then moves them to ``device``, so the CPU and the
card hold the same weights; ``seed=None`` leaves them to be loaded
(``load_state_dict``, e.g. of ``convert.lm_params_from_reference``).
Parameters stay float32 and are cast to ``cfg.dtype`` at each use, as in
the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (RMSNorm, _dtype, dense_init, remat,
                                       rmsnorm)

# sequence-chunk size of the chunked loss (the full (B, S, V) f32 logits of
# a 256k-vocab model are not materialised at once)
LOSS_CHUNK = 256


def _chunk_nll(xs, head, ls):
    """Summed next-token cross entropy (+ z-loss) of one sequence chunk."""
    logits = (xs @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, ls[..., None].long())[..., 0]
    nll = (logz - ll) + 1e-4 * (logz ** 2)
    return nll.sum()


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, seed: int | None = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = (torch.Generator().manual_seed(seed) if seed is not None
               else None)
        self.cfg = cfg
        self.embed = dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0,
                                device=dev)
        self.blocks = nn.ModuleList(
            tr.Block(cfg, kind, gen, dev) for kind in tr.layer_kinds(cfg))
        self.final_norm = RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(gen, (cfg.d_model, cfg.vocab),
                                      device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------------------------------------------------- forward --
    def _embed_inputs(self, batch) -> torch.Tensor:
        cfg = self.cfg
        dt = _dtype(cfg)
        if cfg.family == "audio":
            return batch["frames"].to(dt)
        x = self.embed[batch["tokens"]].to(dt)
        # scaled in the activation dtype, as a weak-typed scalar is in jnp
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)

    def _ctx(self, batch):
        if self.cfg.family == "vlm":
            return batch["image_embeds"].to(_dtype(self.cfg))
        return None

    def _head(self, dtype) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            # tied head, rescaled so init logits are O(1) like an untied one
            return self.embed.T.to(dtype) * torch.tensor(
                cfg.d_model ** -0.5, dtype=dtype)
        return self.lm_head.to(dtype)

    def _backbone(self, batch) -> torch.Tensor:
        """Final-norm hidden states (B, S, D)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = tr.stack_forward(self.blocks, self.cfg, x, positions,
                             ctx=self._ctx(batch))
        return rmsnorm(self.final_norm, x)

    def logits(self, batch) -> torch.Tensor:
        x = self._backbone(batch)
        return (x @ self._head(x.dtype)).float()

    def loss(self, batch) -> torch.Tensor:
        """Mean next-token cross entropy (+ tiny z-loss), the head and
        softmax run a sequence chunk at a time."""
        x = self._backbone(batch)
        head = self._head(x.dtype)
        labels = batch["labels"]
        B, S, _ = x.shape
        chunk = min(LOSS_CHUNK, S)
        nc = S // chunk if S % chunk == 0 else 1
        chunk = S // nc
        total = torch.zeros((), device=x.device)
        for c in range(nc):
            # checkpointed: the backward recomputes a chunk's (b, chunk, V)
            # f32 logits instead of keeping every chunk's (2.1 GB a chunk
            # for a 256k vocabulary at batch 8)
            total = total + remat(_chunk_nll, x[:, c * chunk:(c + 1) * chunk],
                                  head, labels[:, c * chunk:(c + 1) * chunk])
        return total / (B * S)

    # ---------------------------------------------------------- serving --
    @torch.no_grad()
    def prefill(self, batch):
        """Prompt pass: returns (last-position logits (B, 1, V), caches)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, caches = tr.stack_prefill(self.blocks, self.cfg, x, positions,
                                     ctx=self._ctx(batch))
        x = rmsnorm(self.final_norm, x[:, -1:, :])
        return (x @ self._head(x.dtype)).float(), caches

    @torch.no_grad()
    def decode_step(self, batch, pos: int, caches):
        """One new token at position ``pos`` against the caches (the
        attention caches are written in place)."""
        x = self._embed_inputs(batch)                         # (B, 1, D)
        x, caches = tr.stack_decode(self.blocks, self.cfg, x, pos, caches,
                                    ctx=self._ctx(batch))
        x = rmsnorm(self.final_norm, x)
        return (x @ self._head(x.dtype)).float(), caches

    def init_caches(self, batch: int, capacity: int) -> list:
        """Zero caches with the given KV capacity, one entry per layer."""
        cfg = self.cfg
        dt = _dtype(cfg)
        dev = self.device
        hd = cfg.resolved_head_dim
        window = tr.attention_window(cfg)

        def one(kind):
            if kind == "ssm":
                return ssm_mod.ssm_init_cache(cfg, batch, dt, dev)
            if kind == "rglru":
                return rg.rglru_init_cache(cfg, batch, dt, dev)
            if kind == "cross":
                T = cfg.n_frontend_tokens
            else:
                T = min(capacity, window) if window else capacity
            shape = (batch, T, cfg.n_kv_heads, hd)
            return (torch.zeros(shape, dtype=dt, device=dev),
                    torch.zeros(shape, dtype=dt, device=dev))

        return [one(kind) for kind in tr.layer_kinds(cfg)]

