"""Mamba-2 (SSD / state-space duality) block: forward, prefill and decode.

Counterpart of ``repro.models.ssm``.  Chunked SSD (Dao & Gu,
arXiv:2405.21060, "minimal SSD" form): within a chunk the recurrence is a
masked attention-like product; across chunks the (B, H, P, N) state is
carried by a loop over chunks.  Decode is the O(1) single-step state
update.

Layout: x (B, S, d_inner) viewed as (B, S, H, P); the B/C projections are
single-group (B, S, N), shared across heads; A is a per-head scalar decay.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import RMSNorm, const_init, dense_init, rmsnorm


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d = cfg.d_model
        din = cfg.d_inner
        N = cfg.ssm_state
        H = cfg.ssm_heads
        K = cfg.ssm_conv
        conv_ch = din + 2 * N
        self.norm = RMSNorm(d, device)
        self.in_x = dense_init(gen, (d, din), device=device)
        self.in_z = dense_init(gen, (d, din), device=device)
        self.in_B = dense_init(gen, (d, N), device=device)
        self.in_C = dense_init(gen, (d, N), device=device)
        self.in_dt = dense_init(gen, (d, H), device=device)
        self.dt_bias = const_init(torch.zeros(H), device)
        self.A_log = const_init(
            torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)),
            device)
        self.D = const_init(torch.ones(H), device)
        self.conv_w = dense_init(gen, (K, conv_ch), scale=0.1, device=device)
        self.conv_b = const_init(torch.zeros(conv_ch), device)
        self.out_norm = RMSNorm(din, device)
        self.out = dense_init(gen, (din, d), device=device)


def _causal_conv(p: SSM, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel K.  xbc: (B, S, C)."""
    K = p.conv_w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + S, :] * p.conv_w[i].to(xbc.dtype)
    return F.silu(out + p.conv_b.to(xbc.dtype))


def _proj_inputs(p: SSM, cfg: ModelConfig, x: torch.Tensor):
    dt_ = x.dtype
    h = rmsnorm(p.norm, x)
    z = h @ p.in_z.to(dt_)
    xc = h @ p.in_x.to(dt_)
    Bc = h @ p.in_B.to(dt_)
    Cc = h @ p.in_C.to(dt_)
    dt = F.softplus((h @ p.in_dt.to(dt_)).float() + p.dt_bias)   # (B,S,H)
    return z, xc, Bc, Cc, dt


def _ssd_chunked(cfg: ModelConfig, xh, Bc, Cc, dt, A, init_state=None):
    """Chunked SSD scan.

    xh: (B,S,H,P) f32; Bc/Cc: (B,S,N) f32; dt: (B,S,H) f32; A: (H,) f32<0.
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    Bsz, S0, H, P = xh.shape
    N = Bc.shape[-1]
    Q = min(cfg.ssm_chunk, S0)
    pad = (-S0) % Q
    if pad:
        # zero-pad the tail: dt=0 there, so decay=1 and contribution=0 —
        # the carried state is unaffected
        def zp(t):
            return F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        xh, Bc, Cc, dt = zp(xh), zp(Bc), zp(Cc), zp(dt)
    S = S0 + pad
    nc = S // Q

    def r(t):      # chunk-major: (nc, B, Q, ...)
        return t.reshape(Bsz, nc, Q, *t.shape[2:]).transpose(0, 1)

    xh, Bc, Cc, dt = r(xh), r(Bc), r(Cc), r(dt)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    state = (init_state if init_state is not None
             else torch.zeros((Bsz, H, P, N), device=xh.device))
    ys = []
    for xh_c, B_c, C_c, dt_c in zip(xh, Bc, Cc, dt):       # (B,Q,...)
        dA = dt_c * A[None, None, :]                      # (B,Q,H) < 0
        La = torch.cumsum(dA, dim=1)
        # intra-chunk: decay from t..s, masked in the exponent
        seg = La[:, :, None, :] - La[:, None, :, :]       # (B,Q,Q,H)
        seg = torch.where(causal[None, :, :, None], seg, -1e30)
        M = (torch.exp(seg)
             * torch.einsum("bsn,btn->bst", C_c, B_c)[..., None]
             * dt_c[:, None, :, :])                       # (B,Q,Q,H)
        y_intra = torch.einsum("bsth,bthp->bshp", M, xh_c)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bsh,bsn,bhpn->bshp", torch.exp(La), C_c,
                               state)
        # state update
        dec_last = torch.exp(La[:, -1:, :] - La)          # (B,Q,H)
        contrib = torch.einsum("bth,bthp,btn->bhpn", dec_last * dt_c, xh_c,
                               B_c)
        state = state * torch.exp(La[:, -1, :])[..., None, None] + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)[:, :S0]
    return y, state


def _ssd_block(p: SSM, cfg: ModelConfig, x, conv_in, z, dt, norm=rmsnorm):
    """Conv, SSD scan, gate and output projection over a whole sequence:
    (the branch without the residual, final state).  ``norm`` is the gated
    output norm over ``d_inner`` (a tensor-parallel slice passes one that
    sums its squares across the slices)."""
    Bsz, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    conv_out = _causal_conv(p, conv_in)
    xc, Bc, Cc = torch.split(conv_out, [cfg.d_inner, cfg.ssm_state,
                                        cfg.ssm_state], dim=-1)
    A = -torch.exp(p.A_log)
    xh = xc.reshape(Bsz, S, H, P).float()
    y, final = _ssd_chunked(cfg, xh, Bc.float(), Cc.float(), dt, A)
    y = y + xh * p.D[None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner).to(x.dtype)
    y = norm(p.out_norm, y * F.silu(z))
    return y @ p.out.to(x.dtype), final


def ssm_delta(p: SSM, cfg: ModelConfig, x: torch.Tensor, norm=rmsnorm,
              with_cache: bool = False):
    """The SSM branch (B, S, D) without the residual; with ``with_cache``
    also the serving cache (the final state and the conv tail)."""
    z, xc, Bc, Cc, dt = _proj_inputs(p, cfg, x)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    delta, final = _ssd_block(p, cfg, x, conv_in, z, dt, norm)
    if not with_cache:
        return delta
    S = x.shape[1]
    return delta, {"state": final,
                   "conv": conv_in[:, S - (cfg.ssm_conv - 1):, :]}


def ssm_forward(p: SSM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training forward (B, S, D) -> (B, S, D), residual included."""
    return x + ssm_delta(p, cfg, x)


# ------------------------------------------------------------- serving ----

def ssm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K = cfg.ssm_conv
    conv_ch = cfg.d_inner + 2 * N
    return {
        "state": torch.zeros((batch, H, P, N), device=device),
        "conv": torch.zeros((batch, K - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def ssm_prefill(p: SSM, cfg: ModelConfig, x):
    """Forward over a prompt, returning output and the serving cache."""
    delta, cache = ssm_delta(p, cfg, x, with_cache=True)
    return x + delta, cache


def ssm_decode(p: SSM, cfg: ModelConfig, x, cache):
    """One-token step.  x: (B, 1, D).  Returns (out, new_cache)."""
    delta, cache = ssm_decode_delta(p, cfg, x, cache)
    return x + delta, cache


def ssm_decode_delta(p: SSM, cfg: ModelConfig, x, cache, norm=rmsnorm):
    """One-token step's branch, without the residual: (delta, new_cache)."""
    Bsz = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xc, Bc, Cc, dt = _proj_inputs(p, cfg, x)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                  # (B,1,C)
    window = torch.cat([cache["conv"], conv_in], dim=1)        # (B,K,C)
    w = p.conv_w.to(x.dtype)                                   # (K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w)
                      + p.conv_b.to(x.dtype))[:, None, :]
    xc, Bc, Cc = torch.split(conv_out, [cfg.d_inner, N, N], dim=-1)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt[:, 0, :] * A[None, :])                    # (B,H)
    xh = xc.reshape(Bsz, H, P).float()
    contrib = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh, Bc[:, 0].float())
    state = cache["state"] * a[..., None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), state)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(Bsz, 1, cfg.d_inner).to(x.dtype)
    y = norm(p.out_norm, y * F.silu(z))
    return y @ p.out.to(x.dtype), {"state": state, "conv": window[:, 1:, :]}
