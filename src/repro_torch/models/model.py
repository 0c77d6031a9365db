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

When the parameters are DTensors (:func:`repro_torch.launch.sharding.
distribute_lm`), ``loss``, ``prefill`` and ``decode_step`` run sharded over
their mesh (:mod:`repro_torch.models.parallel`); the batch is then a dict
of DTensors too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import parallel
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (RMSNorm, _dtype, dense_init, remat,
                                       rmsnorm)

# sequence-chunk size of the chunked loss (the full (B, S, V) f32 logits of
# a 256k-vocab model are not materialised at once)
LOSS_CHUNK = 256


def _chunk_nll(xs, head, ls, pick=None):
    """Summed next-token cross entropy (+ z-loss) of one sequence chunk.
    ``pick(logits, logz, ls) -> (logz, label logits)`` combines a vocabulary
    split over ranks (:mod:`repro_torch.models.parallel`); without it the
    head holds the whole vocabulary."""
    logits = (xs @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    if pick is None:
        ll = logits.gather(-1, ls[..., None].long())[..., 0]
    else:
        logz, ll = pick(logits, logz, ls)
    nll = (logz - ll) + 1e-4 * (logz ** 2)
    return nll.sum()


def chunked_nll(x, head, labels, pick=None) -> torch.Tensor:
    """The summed NLL of hidden states ``x`` (B, S, D) under ``head`` (D, V),
    the head and softmax run a sequence chunk at a time (``pick`` as in
    :func:`_chunk_nll`)."""
    S = x.shape[1]
    chunk = min(LOSS_CHUNK, S)
    nc = S // chunk if S % chunk == 0 else 1
    chunk = S // nc
    total = torch.zeros((), device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        # checkpointed: the backward recomputes a chunk's (b, chunk, V) f32
        # logits instead of keeping every chunk's (2.1 GB a chunk for a
        # 256k vocabulary at batch 8)
        total = total + remat(_chunk_nll, x[:, sl], head, labels[:, sl], pick)
    return total


def scale_embed(e: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding rows ``e`` in the activation dtype, times sqrt(d_model)
    in that dtype, as a weak-typed scalar is in jnp."""
    dt = _dtype(cfg)
    return e.to(dt) * torch.tensor(cfg.d_model ** 0.5, dtype=dt)


def head_matrix(w: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """The (D, V) head in ``dtype`` from ``w``: ``lm_head``, or the (V, D)
    embedding table when tied, rescaled so init logits are O(1) like an
    untied one."""
    if cfg.tie_embeddings:
        return w.T.to(dtype) * torch.tensor(cfg.d_model ** -0.5, dtype=dtype)
    return w.to(dtype)


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
        # the mesh axis that splits the tensors (tensor parallelism) once
        # the parameters are DTensors (``launch.sharding.distribute_lm``)
        self.tp_axis: str | None = None
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(gen, (cfg.d_model, cfg.vocab),
                                      device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------------------------------------------------- forward --
    def _embed_inputs(self, batch) -> torch.Tensor:
        cfg = self.cfg
        if cfg.family == "audio":
            return batch["frames"].to(_dtype(cfg))
        return scale_embed(F.embedding(batch["tokens"], self.embed), cfg)

    def _ctx(self, batch):
        if self.cfg.family == "vlm":
            return batch["image_embeds"].to(_dtype(self.cfg))
        return None

    def _head(self, dtype) -> torch.Tensor:
        w = self.embed if self.cfg.tie_embeddings else self.lm_head
        return head_matrix(w, self.cfg, dtype)

    def _backbone(self, batch) -> torch.Tensor:
        """Final-norm hidden states (B, S, D)."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = tr.stack_forward(self.blocks, self.cfg, x, positions,
                             ctx=self._ctx(batch))
        return rmsnorm(self.final_norm, x)

    def logits(self, batch) -> torch.Tensor:
        if parallel.is_sharded(self):
            raise NotImplementedError("LM.logits on DTensor parameters: "
                                      "use loss, prefill or decode_step")
        x = self._backbone(batch)
        return (x @ self._head(x.dtype)).float()

    def loss(self, batch) -> torch.Tensor:
        """Mean next-token cross entropy (+ tiny z-loss), the head and
        softmax run a sequence chunk at a time (:func:`chunked_nll`)."""
        if parallel.is_sharded(self):
            return parallel.loss(self, batch)
        x = self._backbone(batch)
        B, S, _ = x.shape
        return chunked_nll(x, self._head(x.dtype), batch["labels"]) / (B * S)

    # ---------------------------------------------------------- serving --
    @torch.no_grad()
    def prefill(self, batch):
        """Prompt pass: returns (last-position logits (B, 1, V), caches)."""
        if parallel.is_sharded(self):
            return parallel.prefill(self, batch)
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
        if parallel.is_sharded(self):
            return parallel.decode_step(self, batch, pos, caches)
        x = self._embed_inputs(batch)                         # (B, 1, D)
        x, caches = tr.stack_decode(self.blocks, self.cfg, x, pos, caches,
                                    ctx=self._ctx(batch))
        x = rmsnorm(self.final_norm, x)
        return (x @ self._head(x.dtype)).float(), caches

    def init_caches(self, batch: int, capacity: int, device=None) -> list:
        """Zero caches with the given KV capacity, one entry per layer (on
        the model's device unless ``device`` is given)."""
        cfg = self.cfg
        dt = _dtype(cfg)
        dev = torch.device(device) if device is not None else self.device
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

    # ------------------------------------------------------ dry-run specs --
    @classmethod
    def abstract(cls, cfg: ModelConfig, device=None) -> "LM":
        """The model with unfilled parameters and no draw: on ``meta`` (the
        default), or made with ``torch.empty`` on ``device``; inside a
        ``FakeTensorMode`` those are fake and hold nothing."""
        lm = cls(cfg, seed=None, device="meta")
        if device is not None and torch.device(device).type != "meta":
            for name, p in list(lm.named_parameters()):
                mod, _, leaf = name.rpartition(".")
                owner = lm.get_submodule(mod) if mod else lm
                setattr(owner, leaf, nn.Parameter(torch.empty(
                    p.shape, dtype=p.dtype, device=device)))
        return lm

    def abstract_params(self) -> dict[str, torch.Tensor]:
        """``{name: tensor}`` of the parameters' shapes and dtypes, on
        ``meta``: no storage, no host draw (the reference's
        ``eval_shape`` of ``init``)."""
        return {k: torch.empty_like(v, device="meta")
                for k, v in self.named_parameters()}

    def input_specs(self, shape, device=None) -> dict:
        """Stand-ins for every model input of a cell (the reference's
        ``ShapeDtypeStruct``s), allocated with ``torch.empty`` on
        ``device`` (default: the model's): inside a ``FakeTensorMode`` they
        are fake and hold nothing.  Decode also gets the caches at capacity
        ``seq_len`` and ``pos``, the last position."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dev = torch.device(device) if device is not None else self.device
        dt = _dtype(cfg)

        def text_inputs(seq):
            if cfg.family == "audio":
                return {"frames": torch.empty((B, seq, cfg.d_model),
                                              dtype=dt, device=dev)}
            return {"tokens": torch.zeros((B, seq), dtype=torch.long,
                                          device=dev)}

        def image(batch):
            if cfg.family == "vlm":
                batch["image_embeds"] = torch.empty(
                    (B, cfg.n_frontend_tokens, cfg.d_model), dtype=dt,
                    device=dev)
            return batch

        if shape.kind == "train":
            batch = text_inputs(S)
            batch["labels"] = torch.zeros((B, S), dtype=torch.long,
                                          device=dev)
            return {"batch": image(batch)}
        if shape.kind == "prefill":
            return {"batch": image(text_inputs(S))}
        caches = self.init_caches(B, S, device=dev)
        return {"batch": image(text_inputs(1)), "pos": S - 1,
                "caches": caches}
