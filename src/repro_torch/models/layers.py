"""Transformer building blocks as ``nn.Module``s.

Counterpart of ``repro.models.layers``.  A module holds its parameters
under the reference's names and shapes (``wq`` is ``(d, H, hd)``, ``wo``
``(H, hd, d)``, ...), and the reference's functions keep their names and
arguments, ``p`` being the module instead of a dict (``attention(p, cfg,
x, positions)``).

Conventions, as in the reference:

* parameters are float32 and are cast to the activation dtype
  (``cfg.dtype``) at each use;
* activations flow as (B, S, D) in ``cfg.dtype``; norms, rope and softmax
  compute in float32 and cast back; attention scores accumulate in f32 and
  the probabilities are cast to the activation dtype before the PV product;
* masked scores are ``-1e30``; GeLU is the tanh approximation
  (``jax.nn.gelu``'s default).

Initialisation draws from an explicit ``torch.Generator`` on the CPU, with
the reference's shapes, scales, fan-in rule (``shape[0]``) and constant
initialisers; its draws are not ``jax.random``'s.  A module built with
``gen=None`` leaves its parameters uninitialised, to be loaded.

Decode caches are written in place: ``attention_decode`` stores the new
K/V into the cache tensors it is given and returns them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def remat(fn, *args, **kwargs):
    """``fn(*args)`` checkpointed while autograd records (its activations
    are recomputed in the backward, as under ``jax.checkpoint``); a plain
    call otherwise.  ``kwargs`` go to ``torch.utils.checkpoint``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def dense_init(gen: torch.Generator | None, shape, scale: float | None = None,
               device=None) -> nn.Parameter:
    """N(0, 1) * scale (default ``shape[0] ** -0.5``), float32, drawn on
    the CPU from ``gen`` and moved to ``device``; empty when ``gen`` is
    None."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                        device=device))
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return nn.Parameter(w.to(device))


def const_init(value: torch.Tensor, device=None) -> nn.Parameter:
    return nn.Parameter(value.to(torch.float32).to(device))


# ------------------------------------------------------------------ norm --

class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = const_init(torch.ones(dim), device)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale
    return out.to(x.dtype)


# ------------------------------------------------------------------ rope --

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) or (S,) -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention --

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, cross: bool = False,
                 device=None):
        super().__init__()
        d, H, KV, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim)
        self.wq = dense_init(gen, (d, H, hd), device=device)
        self.wk = dense_init(gen, (d, KV, hd), device=device)
        self.wv = dense_init(gen, (d, KV, hd), device=device)
        self.wo = dense_init(gen, (H, hd, d), scale=(H * hd) ** -0.5,
                             device=device)
        self.norm = RMSNorm(d, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)
        if cross:
            self.kv_norm = RMSNorm(d, device)


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
         kv_src: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", kv_src, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p.wv.to(dt))
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    return q, k, v


def _sdpa(q, k, v, mask, n_kv: int):
    """q: (B,S,H,hd), k/v: (B,T,KV,hd); GQA via head grouping; f32 softmax."""
    B, S, H, hd = q.shape
    G = H // n_kv
    qg = q.reshape(B, S, n_kv, G, hd)
    # f32 accumulation of the activation-dtype products
    scores = torch.einsum("bsngk,btnk->bngst", qg.float(), k.float())
    scores = scores / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bngst,btnk->bsngk", probs.to(q.dtype), v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, T: int, window: int = 0, device=None) -> torch.Tensor:
    """(1,1,1,S,T) causal (optionally banded/local) mask; True = attend."""
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None, None, None]


# Sequence length above which attention switches to the online-softmax
# chunked path (the full S x T scores of a long prompt would not fit).
CHUNKED_ATTN_THRESHOLD = 2048
ATTN_CHUNK = 1024
CAUSAL_BLOCK_UNROLL = 8     # unroll q chunks (causal blocking) up to here


def _online_q_block(qch, kcs, vcs, qi: int, chunk: int, n_kv: int, G: int,
                    hd: int, window: int, scale: float):
    """One query chunk attending to the KV chunks ``kcs``/``vcs`` (chunk j
    at positions ``j*chunk...``) with an online softmax, in float32."""
    B = qch.shape[0]
    dev = qch.device
    qg = qch.reshape(B, chunk, n_kv, G, hd).float() * scale
    m_run = torch.full((B, n_kv, G, chunk), -1e30, device=dev)
    l_run = torch.zeros((B, n_kv, G, chunk), device=dev)
    acc = torch.zeros((B, n_kv, G, chunk, hd), device=dev)
    qpos = qi * chunk + torch.arange(chunk, device=dev)[:, None]
    for kj, (kch, vch) in enumerate(zip(kcs, vcs)):
        s = torch.einsum("bsngk,btnk->bngst", qg, kch.float())
        kpos = kj * chunk + torch.arange(chunk, device=dev)[None, :]
        msk = kpos <= qpos
        if window:
            msk &= kpos > qpos - window
        s = torch.where(msk[None, None, None], s, -1e30)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngst,btnk->bngsk", pexp, vch.float())
        m_run = m_new
    o = acc / l_run.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, chunk, n_kv * G, hd
                                            ).to(qch.dtype)


def _band_q_block(qch, kp, vp, ci: int, chunk: int, span: int, n_kv: int,
                  G: int, hd: int, window: int, scale: float):
    """Query chunk ``ci`` against its ``span``-long KV slice of the padded
    ``kp``/``vp`` (local attention)."""
    B = qch.shape[0]
    dev = qch.device
    start = ci * chunk                # in padded coords
    ks = kp[:, start:start + span]
    vs = vp[:, start:start + span]
    qg = qch.reshape(B, chunk, n_kv, G, hd)
    s = torch.einsum("bsngk,btnk->bngst", qg.float(), ks.float()) * scale
    qpos = ci * chunk + torch.arange(chunk, device=dev)[:, None]
    kpos = (ci * chunk + torch.arange(span, device=dev)[None, :]
            - (span - chunk))
    m = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
    s = torch.where(m[None, None, None], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(qch.dtype)
    o = torch.einsum("bngst,btnk->bsngk", pr, vs)
    return o.reshape(B, chunk, n_kv * G, hd)


def _sdpa_chunked(q, k, v, n_kv: int, window: int = 0,
                  chunk: int | None = None):
    """Flash-style causal attention: a loop over query chunks; per q-chunk
    either a banded KV slice (local attention) or an online softmax over KV
    chunks (only its causal ones while there are at most
    ``CAUSAL_BLOCK_UNROLL`` q chunks).  Peak memory O(chunk^2) instead of
    O(S*T); under autograd each q chunk is checkpointed, so the backward
    recomputes its scores instead of keeping them.

    q: (B,S,H,hd); k/v: (B,S,KV,hd).  Self-attention (S == T) only.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // n_kv
    chunk = min(chunk or ATTN_CHUNK, S)   # module attr read at call time
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nq = S // chunk
    scale = hd ** -0.5
    qc = q.reshape(B, nq, chunk, H, hd).transpose(0, 1)

    if window and window + chunk < S:
        # banded path: each q chunk attends to a fixed-size KV slice
        span = window + chunk
        kp = F.pad(k, (0, 0, 0, 0, span - chunk, 0))
        vp = F.pad(v, (0, 0, 0, 0, span - chunk, 0))
        outs = [remat(_band_q_block, qc[ci], kp, vp, ci, chunk, span, n_kv,
                      G, hd, window, scale) for ci in range(nq)]
        return torch.stack(outs, dim=1).reshape(B, S, H, hd)

    kc = k.reshape(B, nq, chunk, KV, hd).transpose(0, 1)
    vc = v.reshape(B, nq, chunk, KV, hd).transpose(0, 1)
    # causal-aware blocking while unrolled: chunk i reads only its i+1
    # causal KV chunks; past that, every q chunk runs over all of them and
    # masks, as the reference's scan does
    causal_only = 1 < nq <= CAUSAL_BLOCK_UNROLL
    outs = [remat(_online_q_block, qc[qi],
                  kc[: qi + 1] if causal_only else kc,
                  vc[: qi + 1] if causal_only else vc, qi, chunk, n_kv, G,
                  hd, window, scale)
            for qi in range(nq)]
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def _self_attention_core(q, k, v, n_kv: int, window: int, S: int):
    if S > CHUNKED_ATTN_THRESHOLD:
        return _sdpa_chunked(q, k, v, n_kv, window=window)
    return _sdpa(q, k, v, causal_mask(S, S, window, q.device), n_kv)


def _kv_select(k, v, kv: slice | None):
    """The KV heads this rank's query heads read (all of them: None)."""
    if kv is None:
        return k, v
    return k[:, :, kv], v[:, :, kv]


def attention_delta(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int = 0,
                    kv: slice | None = None, with_cache: bool = False):
    """The self-attention branch (training/prefill), without the residual.

    ``kv`` selects the KV heads the query heads of ``p`` read when ``p``
    holds a tensor-parallel slice of the query heads beside every KV head;
    ``cfg.n_kv_heads`` is then the selected count.  With ``with_cache``
    also returns the (k, v) cache content (every KV head of ``p``)."""
    h = rmsnorm(p.norm, x)
    q, k, v = _qkv(p, cfg, h, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    o = _self_attention_core(q, *_kv_select(k, v, kv), cfg.n_kv_heads,
                             window, S)
    delta = torch.einsum("bshk,hkd->bsd", o, p.wo.to(x.dtype))
    return (delta, (k, v)) if with_cache else delta


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Full (training/prefill) self-attention with residual."""
    return x + attention_delta(p, cfg, x, positions, window)


def cross_attention_delta(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                          ctx: torch.Tensor, kv: slice | None = None
                          ) -> torch.Tensor:
    """The cross-attention branch, without the residual (``kv`` as in
    :func:`attention_delta`)."""
    h = rmsnorm(p.norm, x)
    c = rmsnorm(p.kv_norm, ctx)
    q, k, v = _qkv(p, cfg, h, c)
    o = _sdpa(q, *_kv_select(k, v, kv), None, cfg.n_kv_heads)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(x.dtype))


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    ctx: torch.Tensor) -> torch.Tensor:
    """Cross-attention over a (B, T, D) context (VLM image tokens)."""
    return x + cross_attention_delta(p, cfg, x, ctx)


# -------------------------------------------------- attention: serving ----

def cross_kv(p: Attention, cfg: ModelConfig, ctx: torch.Tensor):
    """The projected image K/V a cross layer caches once (fixed during
    decode)."""
    c = rmsnorm(p.kv_norm, ctx)
    _, k, v = _qkv(p, cfg, c, c)
    return k, v


def cross_attention_decode_delta(p: Attention, cfg: ModelConfig, x, k, v,
                                 kv: slice | None = None) -> torch.Tensor:
    """One token's cross-attention branch against the cached image K/V
    (``kv`` as in :func:`attention_delta`)."""
    h = rmsnorm(p.norm, x)
    q = torch.einsum("bsd,dhk->bshk", h, p.wq.to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q)
    k, v = _kv_select(k, v, kv)
    o = _sdpa(q, k.to(x.dtype), v.to(x.dtype), None, cfg.n_kv_heads)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(x.dtype))


def ring_window(k: torch.Tensor, v: torch.Tensor, window: int):
    """A prompt's (k, v) cut to the last ``window`` positions, rolled so
    position p sits at slot p % window (the layout the decode ring writes
    expect)."""
    S = k.shape[1]
    if window and S >= window:
        k = torch.roll(k[:, -window:], S % window, dims=1)
        v = torch.roll(v[:, -window:], S % window, dims=1)
    return k, v


def attention_prefill(p: Attention, cfg: ModelConfig, x, positions,
                      window: int = 0):
    """Like ``attention`` but also returns the (k, v) cache content."""
    delta, kv = attention_delta(p, cfg, x, positions, window,
                                with_cache=True)
    return x + delta, kv


def attention_decode_delta(p: Attention, cfg: ModelConfig, x, cache_kv,
                           pos: int, window: int = 0,
                           kv: slice | None = None):
    """One-token decode branch, without the residual (``kv`` as in
    :func:`attention_delta`; the cache holds every KV head of ``p``).
    Writes the new K/V into the cache in place; returns (delta, cache)."""
    h = rmsnorm(p.norm, x)
    q, k, v = _qkv(p, cfg, h, h)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    ck, cv = cache_kv
    T = ck.shape[1]
    slot = pos % T if window else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    kpos = torch.arange(T, device=x.device)
    if window:
        # ring buffer: valid entries are the last `window` positions
        age = (slot - kpos) % T
        mask = (age < min(pos + 1, T))[None, None, None, None, :]
    else:
        mask = (kpos <= pos)[None, None, None, None, :]
    ks, vs = _kv_select(ck, cv, kv)
    o = _sdpa(q, ks.to(q.dtype), vs.to(q.dtype), mask, cfg.n_kv_heads)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(x.dtype)), (ck, cv)


def attention_decode(p: Attention, cfg: ModelConfig, x, cache_kv, pos: int,
                     window: int = 0):
    """One-token decode. x: (B, 1, D); cache_kv: (k, v) each
    (B, S_max, KV, hd) (or a (B, window, KV, hd) ring for local attention);
    pos: the current position.  Writes the new K/V into the cache in place
    and returns (out, cache)."""
    delta, cache = attention_decode_delta(p, cfg, x, cache_kv, pos, window)
    return x + delta, cache


# ------------------------------------------------------------------- mlp --

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, d_ff: int | None = None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        f = d_ff or cfg.d_ff
        self.norm = RMSNorm(d, device)
        self.wi = dense_init(gen, (d, f), device=device)
        self.wo = dense_init(gen, (f, d), device=device)
        if cfg.mlp in ("swiglu", "geglu"):
            self.wg = dense_init(gen, (d, f), device=device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _mlp_core(p: MLP, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    up = h @ p.wi.to(dt)
    if cfg.mlp == "swiglu":
        act = F.silu(h @ p.wg.to(dt)) * up
    elif cfg.mlp == "geglu":
        act = _gelu(h @ p.wg.to(dt)) * up
    else:
        act = _gelu(up)
    return act @ p.wo.to(dt)


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + _mlp_core(p, cfg, rmsnorm(p.norm, x))


# ------------------------------------------------------------------- moe --

class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.norm = RMSNorm(d, device)
        self.router = dense_init(gen, (d, E), scale=d ** -0.5, device=device)
        self.wi = dense_init(gen, (E, d, f), device=device)
        self.wo = dense_init(gen, (E, f, d), device=device)
        if cfg.mlp in ("swiglu", "geglu"):
            self.wg = dense_init(gen, (E, d, f), device=device)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, gen, d_ff=cfg.d_ff * cfg.n_shared_experts,
                              device=device)


MOE_GROUP = 8192


def moe_routed(p: MoE, cfg: ModelConfig, h: torch.Tensor,
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    """The routed experts' mixture of the normed ``h`` (B, S, D).  Tokens
    are routed in groups of ``MOE_GROUP`` when they divide evenly, as in
    the reference.  ``experts=(lo, hi)``: ``p`` holds experts ``lo..hi-1``
    only, and the mixture sums theirs (an expert-parallel slice)."""
    B, S, D = h.shape
    T = B * S
    if T > MOE_GROUP and T % MOE_GROUP == 0:
        hg = h.reshape(T // MOE_GROUP, MOE_GROUP, D)
        out = torch.stack([_moe_group(p, cfg, g, experts) for g in hg])
        return out.reshape(B, S, D)
    return _moe_group(p, cfg, h.reshape(T, D), experts).reshape(B, S, D)


def moe(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Capacity-based top-k MoE with gather/scatter dispatch.

    Tokens beyond an expert's capacity are dropped (the residual passes
    through); ``capacity_factor`` sets the slack.
    """
    h = rmsnorm(p.norm, x)
    out = moe_routed(p, cfg, h)
    if cfg.n_shared_experts:
        out = out + _mlp_core(p.shared, cfg, h)
    return x + out


def _moe_group(p: MoE, cfg: ModelConfig, ht: torch.Tensor,
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    """Route one token group.  ht: (T, D) -> (T, D) expert mixture."""
    E, K = cfg.n_experts, cfg.experts_per_token
    lo, hi = experts or (0, E)
    T, D = ht.shape
    dt = ht.dtype
    dev = ht.device
    logits = (ht @ p.router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    # top-k, the lower expert first on ties (jax.lax.top_k's order)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[:, :K]         # (T, K)
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = max(1, int(cfg.capacity_factor * T * K / E))
    onehot = F.one_hot(gate_idx, E)                           # (T, K, E)
    # rank within the expert, counted over (token, k) in row-major order
    pos_in_e = (torch.cumsum(onehot.reshape(T * K, E), dim=0)
                .reshape(T, K, E) - onehot)
    pos = (pos_in_e * onehot).sum(-1)                         # (T, K)
    keep = pos < C
    # slot index per (token, k): expert*C + rank; overflow -> dump slot E*C
    slot = torch.where(keep, gate_idx * C + pos, E * C).reshape(-1)
    tkn = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    # kept slots are distinct; the dump slot is never read
    token_of_slot = torch.full((E * C + 1,), T, dtype=torch.int64,
                               device=dev).scatter_(0, slot, tkn)
    gate_of_slot = torch.zeros((E * C + 1,), dtype=torch.float32,
                               device=dev).scatter_(0, slot,
                                                    gate_vals.reshape(-1))
    # gather tokens into expert slots (padding row = zeros)
    ht_pad = torch.cat([ht, torch.zeros((1, D), dtype=dt, device=dev)])
    slots = token_of_slot[lo * C: hi * C]
    xe = ht_pad[slots].reshape(hi - lo, C, D)
    up = torch.einsum("ecd,edf->ecf", xe, p.wi.to(dt))
    if cfg.mlp in ("swiglu", "geglu"):
        g = torch.einsum("ecd,edf->ecf", xe, p.wg.to(dt))
        act = (F.silu(g) if cfg.mlp == "swiglu" else _gelu(g)) * up
    else:
        act = _gelu(up)
    ye = torch.einsum("ecf,efd->ecd", act, p.wo.to(dt))
    ye = (ye.reshape((hi - lo) * C, D)
          * gate_of_slot[lo * C: hi * C, None].to(ye.dtype))
    # scatter-add back to tokens (a token's k slots accumulate), in the
    # activation dtype; empty slots land on the discarded row T
    yt = torch.zeros((T + 1, D), dtype=ye.dtype, device=dev).index_add_(
        0, slots, ye)[:T]
    return yt.to(dt)
