"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  Recurrent branch: linear -> causal
depthwise conv -> RG-LRU; gate branch: linear -> GeLU; merged
multiplicatively and projected back.  The RG-LRU:

    r_t = sigmoid(W_a xi_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x xi_t + b_x)          (input gate)
    log a_t = c * r_t * log sigmoid(Lambda)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

The reference runs the linear recurrence as ``jax.lax.associative_scan``;
here it is a scan over the sequence (the same recurrence, summed in
sequence order).  Decode is the O(1) single step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (RMSNorm, _gelu, const_init, dense_init,
                                       rmsnorm)

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        K = cfg.ssm_conv
        self.norm = RMSNorm(d, device)
        self.in_rec = dense_init(gen, (d, w), device=device)
        self.in_gate = dense_init(gen, (d, w), device=device)
        self.conv_w = dense_init(gen, (K, w), scale=0.1, device=device)
        self.conv_b = const_init(torch.zeros(w), device)
        self.w_a = dense_init(gen, (w, w), device=device)
        self.b_a = const_init(torch.zeros(w), device)
        self.w_x = dense_init(gen, (w, w), device=device)
        self.b_x = const_init(torch.zeros(w), device)
        if gen is None:
            self.lam = const_init(torch.empty(w), device)
        else:
            # Lambda so that a in [0.9, 0.999] at r=1 (Griffin appendix)
            u = 0.9 + (0.999 - 0.9) * torch.rand((w,), generator=gen)
            lam = torch.log(u ** (-1.0 / _C) - 1.0)
            self.lam = const_init(-lam, device)
        self.out = dense_init(gen, (w, d), device=device)


def _conv(p: RGLRU, x):
    K = p.conv_w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + S, :] * p.conv_w[i].to(x.dtype)
    return out + p.conv_b.to(x.dtype)


def _gates(p: RGLRU, xi, xi_all=None):
    """a (f32) and the gated input for the RG-LRU.  ``xi_all``: every
    channel of ``xi`` when ``p`` holds a tensor-parallel slice of the
    channels (the gates' products read them all)."""
    xa = xi if xi_all is None else xi_all
    r = torch.sigmoid((xa @ p.w_a.to(xi.dtype)).float() + p.b_a)
    i = torch.sigmoid((xa @ p.w_x.to(xi.dtype)).float() + p.b_x)
    log_a = _C * r * F.logsigmoid(p.lam)[None, None, :]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i * xi.float())
    return a, gated


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, over axis 1: (B, S, W)."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def _recurrence(p: RGLRU, x, gather=None):
    """(the branch without the residual, the pre-conv input, the hidden
    states).  ``gather`` joins a tensor-parallel slice's channels into
    all of them (None: ``p`` holds every channel)."""
    h = rmsnorm(p.norm, x)
    gate = _gelu(h @ p.in_gate.to(x.dtype))
    pre = h @ p.in_rec.to(x.dtype)
    xi = _conv(p, pre)
    a, b = _gates(p, xi, gather(xi) if gather else None)   # (B,S,W) f32
    hseq = _scan(a, b)
    y = (hseq * gate.float()).to(x.dtype)
    return y @ p.out.to(x.dtype), pre, hseq


def rglru_delta(p: RGLRU, cfg: ModelConfig, x, gather=None,
                with_cache: bool = False):
    """The recurrent branch without the residual; with ``with_cache`` also
    the serving cache (the last hidden state and the conv tail)."""
    delta, pre, hseq = _recurrence(p, x, gather)
    if not with_cache:
        return delta
    K = cfg.ssm_conv
    return delta, {"h": hseq[:, -1, :],
                   "conv": pre[:, pre.shape[1] - (K - 1):, :]}


def rglru_forward(p: RGLRU, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Training forward.  (B,S,D)->(B,S,D)."""
    return x + rglru_delta(p, cfg, x)


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    K = cfg.ssm_conv
    return {"h": torch.zeros((batch, w), device=device),
            "conv": torch.zeros((batch, K - 1, w), dtype=dtype,
                                device=device)}


def rglru_prefill(p: RGLRU, cfg: ModelConfig, x):
    delta, cache = rglru_delta(p, cfg, x, with_cache=True)
    return x + delta, cache


def rglru_decode(p: RGLRU, cfg: ModelConfig, x, cache):
    """One-token step.  x: (B, 1, D)."""
    delta, cache = rglru_decode_delta(p, cfg, x, cache)
    return x + delta, cache


def rglru_decode_delta(p: RGLRU, cfg: ModelConfig, x, cache, gather=None):
    """One-token step's branch, without the residual: (delta, new_cache)."""
    h = rmsnorm(p.norm, x)
    gate = _gelu(h @ p.in_gate.to(x.dtype))
    pre = h @ p.in_rec.to(x.dtype)                             # (B,1,W)
    window = torch.cat([cache["conv"], pre], dim=1)            # (B,K,W)
    w = p.conv_w.to(x.dtype)
    xi = (torch.einsum("bkw,kw->bw", window, w)
          + p.conv_b.to(x.dtype))[:, None, :]
    a, b = _gates(p, xi, gather(xi) if gather else None)
    hnew = a[:, 0] * cache["h"] + b[:, 0]
    y = (hnew[:, None, :] * gate.float()).to(x.dtype)
    return y @ p.out.to(x.dtype), {"h": hnew, "conv": window[:, 1:, :]}
