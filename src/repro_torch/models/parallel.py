"""The LM on DTensors: FSDP x tensor parallelism over a ``DeviceMesh``.

When an :class:`~repro_torch.models.model.LM`'s parameters are DTensors
(placed by :func:`repro_torch.launch.sharding.distribute_lm`, which also
sets ``LM.tp_axis``), ``LM.loss``, ``prefill`` and ``decode_step`` come
here.  This is the counterpart of the reference's ``jit`` with
``in_shardings`` on a production mesh: the same model code runs on each
rank's shard, with the collectives GSPMD would insert made explicit.

* The residual stream between layers is a DTensor whose batch dim is split
  over the batch's mesh axes and which is replicated over the rest (the
  reference's ``maybe_shard(x, BATCH_AXES, None, None)`` anchors).
* A layer's branch (attention, MLP, MoE, SSM, RG-LRU) runs on local
  tensors.  Its parameters are gathered over every axis but the
  tensor-parallel one (``LM.tp_axis``: ``model`` under the ``tp_fsdp``
  policy, none under ``fsdp``): an FSDP all-gather whose backward
  reduce-scatters the gradients.  Over the model axis a parameter keeps
  the slice its rule gives it: the query heads, the hidden units, the
  experts, the SSM heads, the RG-LRU channels, the vocabulary.  The branch then computes that slice's share of its output,
  and one all-reduce over the model axis (``Partial`` -> ``Replicate``)
  joins the shares, as Megatron's row-parallel projections do.
* A branch whose rule leaves it unsplit over the model axis (heads that do
  not divide it) runs whole on every model rank and only rank 0 of the axis
  contributes it, so every branch joins the same way and every gradient is
  a plain sum.
* The few reductions that cross a split inside a branch are explicit: the
  SSM's gated norm over ``d_inner`` sums its squares over the axis, the
  RG-LRU gates read every channel, the vocabulary-split loss combines the
  slices' log-sum-exps and picks each label's logit from the slice that
  holds it, and the vocabulary-split embedding adds the slices' rows.
  The loss, the embedding's scale and the head are ``models.model``'s own
  (``chunked_nll``, ``scale_embed``, ``head_matrix``), given this rank's
  slices.

Gradients: a local value converted from a DTensor declares how its
gradient combines over each mesh axis (``to_local(grad_placements=...)``):
a sum over the axes that split the batch and over the model axis, unless
the value itself is split there.  DTensor's backward then reduce-scatters
or all-reduces each parameter's gradient back to the parameter's own
placement.

The sharded path computes in the same order as the plain one, so on a 1x1
mesh it gives the plain path's numbers; with more ranks the sums over
shards add in another order.
"""
from __future__ import annotations

import functools
import types

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import model as lm_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (_dtype, _mlp_core, attention_delta,
                                       attention_decode_delta,
                                       cross_attention_decode_delta,
                                       cross_attention_delta, cross_kv,
                                       moe_routed, ring_window, rmsnorm)


def is_sharded(lm) -> bool:
    return isinstance(lm.embed, DTensor)


# ------------------------------------------------------------- placing ----

def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of ``full`` under ``placements`` (no collective):
    each mesh axis that shards a dim cuts the piece left by the axes before
    it, as ``torch.chunk`` does."""
    coord = mesh.get_coordinate()
    lo, n = [0] * full.ndim, list(full.shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim
            size = -(-n[d] // mesh.size(i))
            start = min(coord[i] * size, n[d])
            lo[d] += start
            n[d] = min(size, n[d] - start)
    return full[tuple(slice(a, a + b) for a, b in zip(lo, n))]


def place(full: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor of ``full`` (the same on every rank) under ``placements``:
    each rank keeps its own piece, nothing is sent."""
    return DTensor.from_local(local_chunk(full, mesh, placements).clone(),
                              mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


# ------------------------------------------------------------ the ranks ----

class _Cfg:
    """``cfg`` with some fields replaced: the shapes of a rank's slice."""

    def __init__(self, cfg, **fields):
        self.__dict__["_cfg"] = cfg
        self.__dict__.update(fields)

    def __getattr__(self, name):
        return getattr(self._cfg, name)


class Par:
    """How one call's tensors lie on the mesh: the batch's axes (from the
    batch's placements) and the tensor-parallel axis (named ``tp_axis``;
    none when that axis splits the batch)."""

    def __init__(self, mesh, batch_placements, tp_axis: str | None):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.batch = tuple(isinstance(pl, Shard) for pl in batch_placements)
        tp = None
        if tp_axis in names:
            i = names.index(tp_axis)
            tp = None if self.batch[i] else i
        self.tp = tp
        self.tp_size = mesh.size(tp) if tp is not None else 1
        self.tp_rank = mesh.get_local_rank(tp) if tp is not None else 0
        # the residual stream: batch split over its axes, replicated else
        self.act = tuple(Shard(0) if b else Replicate() for b in self.batch)

    # a local value used as ``use`` over axis i: how its gradient combines
    def _grad(self, i: int, use, replicated: bool = False):
        if isinstance(use, Shard):
            return use
        if self.batch[i] or (i == self.tp and not replicated):
            return Partial()
        return Replicate()

    def _grads(self, use, replicated: bool = False) -> tuple:
        return tuple(self._grad(i, u, replicated) for i, u in enumerate(use))

    def tp_shard(self, p: DTensor) -> int | None:
        """The dim ``p`` is split on over the model axis, or None (the rules
        split nothing over an axis of one rank)."""
        if self.tp is None:
            return None
        pl = p.placements[self.tp]
        return pl.dim if isinstance(pl, Shard) else None

    def param(self, p: DTensor, keep_tp: bool = True) -> torch.Tensor:
        """``p`` gathered over every axis but the model axis, where it keeps
        its slice (unless ``keep_tp`` is False)."""
        use = tuple(pl if (i == self.tp and keep_tp and isinstance(pl, Shard))
                    else Replicate() for i, pl in enumerate(p.placements))
        return p.redistribute(self.mesh, use).to_local(
            grad_placements=self._grads(use))

    def local(self, x: DTensor) -> torch.Tensor:
        """This rank's piece of the residual stream, entering a branch."""
        x = x.redistribute(self.mesh, self.act)
        return x.to_local(grad_placements=self._grads(self.act))

    def data(self, x: DTensor) -> torch.Tensor:
        """This rank's batch rows of an input."""
        return x.redistribute(self.mesh, self.act).to_local()

    def own(self, t: torch.Tensor, split: bool) -> torch.Tensor:
        """A branch's share: ``t`` when the branch is split over the model
        axis, else ``t`` on its rank 0 and zeros (still in the graph) on
        the others."""
        return t if split or self.tp_rank == 0 else t * 0

    def join(self, t: torch.Tensor) -> DTensor:
        """Sum the model axis' shares ``t`` into the residual stream."""
        pl = tuple(Partial() if i == self.tp else u
                   for i, u in enumerate(self.act))
        return DTensor.from_local(t, self.mesh, pl, run_check=False
                                  ).redistribute(self.mesh, self.act)

    def tp_sum(self, t: torch.Tensor, replicated: bool = False):
        """The sum of ``t`` over the model axis, on every model rank.
        ``replicated``: every model rank computes the same from the sum
        (its gradient is not summed again)."""
        if self.tp is None:
            return t
        d = self.join(t)
        return d.to_local(grad_placements=self._grads(self.act, replicated))

    def tp_gather(self, t: torch.Tensor, dim: int, replicated: bool = False):
        """The model axis' slices ``t`` joined along ``dim`` (``replicated``
        as in :meth:`tp_sum`)."""
        if self.tp is None:
            return t
        pl = tuple(Shard(dim % t.ndim) if i == self.tp else u
                   for i, u in enumerate(self.act))
        d = DTensor.from_local(t, self.mesh, pl, run_check=False
                               ).redistribute(self.mesh, self.act)
        return d.to_local(grad_placements=self._grads(self.act, replicated))

    def layout(self, tp_pl) -> tuple:
        """Placements of a batch-leading tensor split ``tp_pl`` over the
        model axis."""
        return tuple(tp_pl if i == self.tp else u
                     for i, u in enumerate(self.act))

    def cache_in(self, leaf: DTensor, tp_pl) -> torch.Tensor:
        return leaf.redistribute(self.mesh, self.layout(tp_pl)).to_local()

    def cache_out(self, t: torch.Tensor, tp_pl, like=None) -> DTensor:
        d = DTensor.from_local(t, self.mesh, self.layout(tp_pl),
                               run_check=False)
        return d if like is None else d.redistribute(self.mesh,
                                                     like.placements)


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _norm(par: Par, n):
    return _ns(scale=par.param(n.scale))


# ----------------------------------------------------- the layers' slices ---

def _attn_local(par: Par, a, cfg):
    """(local view, local cfg, KV selection, split) of an attention layer.

    Query heads and ``wo`` keep their model-axis slice when the heads
    divide it; the KV heads too when they divide it, else every rank holds
    them all and its query heads read the ones they group with."""
    p = _ns(norm=_norm(par, a.norm))
    for opt in ("q_norm", "k_norm", "kv_norm"):
        if hasattr(a, opt):
            setattr(p, opt, _norm(par, getattr(a, opt)))
    H, KV = cfg.n_heads, cfg.n_kv_heads
    split = par.tp_shard(a.wq) is not None
    if split:
        Hl = H // par.tp_size
        G = H // KV
        kv_split = par.tp_shard(a.wk) is not None
        if not kv_split and Hl % G and G % Hl:
            split = False          # query slices straddle KV groups
    p.wq = par.param(a.wq, split)
    p.wo = par.param(a.wo, split)
    if not split:
        p.wk, p.wv = par.param(a.wk, False), par.param(a.wv, False)
        return p, cfg, None, False, False
    p.wk, p.wv = par.param(a.wk), par.param(a.wv)
    if kv_split:
        return p, _Cfg(cfg, n_heads=Hl, n_kv_heads=KV // par.tp_size), \
            None, True, True
    lo = par.tp_rank * Hl // G
    hi = ((par.tp_rank + 1) * Hl - 1) // G + 1
    return p, _Cfg(cfg, n_heads=Hl, n_kv_heads=hi - lo), slice(lo, hi), \
        True, False


def _mlp_local(par: Par, m):
    split = par.tp_shard(m.wi) is not None
    p = _ns(norm=_norm(par, m.norm), wi=par.param(m.wi, split),
            wo=par.param(m.wo, split))
    if hasattr(m, "wg"):
        p.wg = par.param(m.wg, split)
    return p, split


def _mlp_branch(par: Par, m, cfg, x: DTensor) -> DTensor:
    p, split = _mlp_local(par, m)
    xl = par.local(x)
    return par.join(par.own(_mlp_core(p, cfg, rmsnorm(p.norm, xl)), split))


def _moe_branch(par: Par, m, cfg, x: DTensor) -> DTensor:
    """Experts split over the model axis (expert parallel): every rank
    routes all its tokens and runs its own experts' slots."""
    xl = par.local(x)
    h = rmsnorm(_norm(par, m.norm), xl)
    E = cfg.n_experts
    split = par.tp_shard(m.wi) is not None
    p = _ns(router=par.param(m.router), wi=par.param(m.wi, split),
            wo=par.param(m.wo, split))
    if hasattr(m, "wg"):
        p.wg = par.param(m.wg, split)
    experts = None
    if split:
        El = E // par.tp_size
        experts = (par.tp_rank * El, (par.tp_rank + 1) * El)
    out = par.own(moe_routed(p, cfg, h, experts), split)
    if cfg.n_shared_experts:
        ps, s_split = _mlp_local(par, m.shared)
        out = out + par.own(_mlp_core(ps, cfg, h), s_split)
    return par.join(out)


def _ffn_branch(par: Par, blk, cfg, x: DTensor) -> DTensor:
    if cfg.n_experts and blk.kind == "attn":
        return _moe_branch(par, blk.ffn, cfg, x)
    return _mlp_branch(par, blk.ffn, cfg, x)


def _tp_rmsnorm(par: Par, dim: int):
    """RMSNorm over ``dim`` channels split over the model axis."""
    def norm(p, x, eps: float = 1e-6):
        xf = x.float()
        var = par.tp_sum((xf * xf).sum(-1, keepdim=True)) / dim
        return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)
    return norm


def _ssm_local(par: Par, s, cfg):
    """(local view, local cfg, norm, split, x-channel range) of an SSM
    layer: heads (and their d_inner channels) split over the model axis;
    B/C projections, the conv's B/C channels and the out-norm scale read
    whole and sliced."""
    H, P, din = cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_inner
    split = par.tp_shard(s.in_dt) is not None
    names = ("in_x", "in_z", "in_dt", "dt_bias", "A_log", "D", "out")
    p = _ns(norm=_norm(par, s.norm), in_B=par.param(s.in_B, False),
            in_C=par.param(s.in_C, False),
            **{n: par.param(getattr(s, n), split) for n in names})
    conv_w = par.param(s.conv_w, False)
    conv_b = par.param(s.conv_b, False)
    scale = par.param(s.out_norm.scale, False)
    if not split:
        p.conv_w, p.conv_b, p.out_norm = conv_w, conv_b, _ns(scale=scale)
        return p, cfg, rmsnorm, False, slice(0, din)
    Hl = H // par.tp_size
    xs = slice(par.tp_rank * Hl * P, (par.tp_rank + 1) * Hl * P)
    p.conv_w = torch.cat([conv_w[:, xs], conv_w[:, din:]], dim=1)
    p.conv_b = torch.cat([conv_b[xs], conv_b[din:]])
    p.out_norm = _ns(scale=scale[xs])
    return (p, _Cfg(cfg, d_inner=Hl * P, ssm_heads=Hl),
            _tp_rmsnorm(par, din), True, xs)


def _rglru_local(par: Par, r):
    split = par.tp_shard(r.in_rec) is not None
    names = ("in_rec", "in_gate", "conv_w", "conv_b", "w_a", "b_a", "w_x",
             "b_x", "lam", "out")
    p = _ns(norm=_norm(par, r.norm),
            **{n: par.param(getattr(r, n), split) for n in names})
    gather = functools.partial(par.tp_gather, dim=-1) if split else None
    return p, gather, split


# ------------------------------------------------------------- forward ----

def _block(par: Par, blk, cfg, x: DTensor, positions, ctx) -> DTensor:
    """One layer on the residual stream ``x`` (``ctx``: local image
    tokens)."""
    kind = blk.kind
    if kind == "ssm":
        p, lcfg, norm, split, _ = _ssm_local(par, blk.ssm, cfg)
        xl = par.local(x)
        return x + par.join(par.own(ssm_mod.ssm_delta(p, lcfg, xl, norm),
                                    split))
    if kind == "rglru":
        p, gather, split = _rglru_local(par, blk.rec)
        xl = par.local(x)
        x = x + par.join(par.own(rg.rglru_delta(p, cfg, xl, gather), split))
        return _mlp_residual(par, blk, cfg, x)
    p, lcfg, kv, split, _ = _attn_local(par, blk.attn, cfg)
    xl = par.local(x)
    if kind == "cross":
        d = cross_attention_delta(p, lcfg, xl, ctx, kv)
    else:
        d = attention_delta(p, lcfg, xl, positions,
                            tr.attention_window(cfg), kv)
    x = x + par.join(par.own(d, split))
    return _mlp_residual(par, blk, cfg, x)


def _mlp_residual(par, blk, cfg, x):
    return x + _ffn_branch(par, blk, cfg, x)


def _inputs(lm, batch):
    """(Par, residual stream after the embedding, local image tokens)."""
    cfg = lm.cfg
    dt = _dtype(cfg)
    first = batch["frames" if cfg.family == "audio" else "tokens"]
    par = Par(lm.embed.device_mesh, first.placements, lm.tp_axis)
    ctx = (par.data(batch["image_embeds"]).to(dt) if cfg.family == "vlm"
           else None)
    if cfg.family == "audio":
        frames = par.data(batch["frames"]).to(dt)
        return par, DTensor.from_local(frames, par.mesh, par.act,
                                       run_check=False), ctx
    tok = par.data(batch["tokens"])
    table = par.param(lm.embed)
    split = par.tp_shard(lm.embed) is not None
    if split:
        # vocabulary-split lookup: each rank adds the rows it holds
        lo = par.tp_rank * table.shape[0]
        inside = (tok >= lo) & (tok < lo + table.shape[0])
        e = F.embedding(torch.where(inside, tok - lo, 0), table) \
            * inside[..., None]
    else:
        e = F.embedding(tok, table)
    e = lm_mod.scale_embed(e, cfg)
    return par, par.join(par.own(e, split)), ctx


def _head(par: Par, lm, dtype):
    """(local head (D, V_local), the first vocabulary id it holds, split)."""
    cfg = lm.cfg
    w = lm.embed if cfg.tie_embeddings else lm.lm_head
    split = par.tp_shard(w) is not None
    head = lm_mod.head_matrix(par.param(w, split), cfg, dtype)
    return head, par.tp_rank * head.shape[1] if split else 0, split


def _vocab_pick(par: Par, lo: int):
    """``model._chunk_nll``'s ``pick`` for a head that holds vocabulary ids
    ``lo`` on of a split over the model axis: the slices' log-sum-exps
    combined, each label's logit from the slice that holds it."""
    def pick(logits, logz, ls):
        logz = torch.logsumexp(
            par.tp_gather(logz[..., None], -1, replicated=True), dim=-1)
        inside = (ls >= lo) & (ls < lo + logits.shape[-1])
        ll = logits.gather(-1, torch.where(inside, ls - lo, 0)[..., None]
                           .long())[..., 0] * inside
        return logz, par.tp_sum(ll, replicated=True)
    return pick


def loss(lm, batch) -> DTensor:
    """``LM.loss`` on DTensors: the mean over the global batch, replicated
    on every rank."""
    cfg = lm.cfg
    par, x, ctx = _inputs(lm, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = tr.stack_forward(lm.blocks, cfg, x, positions, ctx,
                         apply=functools.partial(_block, par))
    xl = rmsnorm(_norm(par, lm.final_norm), par.local(x))
    head, lo, split = _head(par, lm, xl.dtype)
    total = lm_mod.chunked_nll(xl, head, par.data(batch["labels"]),
                               _vocab_pick(par, lo) if split else None)
    B, S = x.shape[0], x.shape[1]
    scalar = tuple(Partial() if b else Replicate() for b in par.batch)
    out = DTensor.from_local(total / (B * S), par.mesh, scalar,
                             run_check=False)
    return out.redistribute(par.mesh, (Replicate(),) * len(scalar))


def _logits(par: Par, lm, xl) -> DTensor:
    xl = rmsnorm(_norm(par, lm.final_norm), xl)
    head, _, split = _head(par, lm, xl.dtype)
    lg = (xl @ head).float()
    if split:
        lg = par.tp_gather(lg, -1, replicated=True)
    return DTensor.from_local(lg, par.mesh, par.act, run_check=False)


# ------------------------------------------------------------- serving ----

def _attn_cache_pl(kv_split: bool):
    return Shard(2) if kv_split else Replicate()


@torch.no_grad()
def prefill(lm, batch):
    """``LM.prefill`` on DTensors: (last-position logits (B, 1, V), caches
    as DTensors: KV heads split over the model axis when they divide it,
    SSM state by heads, RG-LRU state by channels)."""
    cfg = lm.cfg
    par, x, ctx = _inputs(lm, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches = []
    for blk in lm.blocks:
        x, c = _block_prefill(par, blk, cfg, x, positions, ctx)
        caches.append(c)
    return _logits(par, lm, par.local(x)[:, -1:, :]), caches


def _block_prefill(par: Par, blk, cfg, x, positions, ctx):
    kind = blk.kind
    if kind == "ssm":
        p, lcfg, norm, split, xs = _ssm_local(par, blk.ssm, cfg)
        d, c = ssm_mod.ssm_delta(p, lcfg, par.local(x), norm,
                                 with_cache=True)
        return x + par.join(par.own(d, split)), _ssm_cache_out(
            par, c, split, lcfg)
    if kind == "rglru":
        p, gather, split = _rglru_local(par, blk.rec)
        d, c = rg.rglru_delta(p, cfg, par.local(x), gather, with_cache=True)
        x = x + par.join(par.own(d, split))
        pl = Shard(1) if split else Replicate()
        c = {"h": par.cache_out(c["h"], pl),
             "conv": par.cache_out(c["conv"],
                                   Shard(2) if split else Replicate())}
        return _mlp_residual(par, blk, cfg, x), c
    p, lcfg, kv, split, kv_split = _attn_local(par, blk.attn, cfg)
    xl = par.local(x)
    pl = _attn_cache_pl(kv_split)
    if kind == "cross":
        d = cross_attention_delta(p, lcfg, xl, ctx, kv)
        k, v = cross_kv(p, lcfg, ctx)
    else:
        window = tr.attention_window(cfg)
        d, (k, v) = attention_delta(p, lcfg, xl, positions, window, kv,
                                    with_cache=True)
        k, v = ring_window(k, v, window)
    x = x + par.join(par.own(d, split))
    return (_mlp_residual(par, blk, cfg, x),
            (par.cache_out(k, pl), par.cache_out(v, pl)))


def _ssm_cache_out(par: Par, c, split: bool, lcfg):
    """The SSM cache as DTensors: the state split by heads, the conv tail
    whole (its d_inner channels joined from the slices)."""
    conv = c["conv"]
    if split:
        xpart = par.tp_gather(conv[..., :lcfg.d_inner], -1, replicated=True)
        conv = torch.cat([xpart, conv[..., lcfg.d_inner:]], dim=-1)
    return {"state": par.cache_out(c["state"],
                                   Shard(1) if split else Replicate()),
            "conv": par.cache_out(conv, Replicate())}


@torch.no_grad()
def decode_step(lm, batch, pos: int, caches):
    """``LM.decode_step`` on DTensors.  Each cache leaf comes in and goes
    out under its own placements (e.g. ``launch.sharding.cache_shardings``'
    rules); inside a layer it is moved to the layout the layer's slice
    reads."""
    cfg = lm.cfg
    par, x, ctx = _inputs(lm, batch)
    new = []
    for blk, c in zip(lm.blocks, caches):
        x, nc = _block_decode(par, blk, cfg, x, pos, c)
        new.append(nc)
    return _logits(par, lm, par.local(x)), new


def _block_decode(par: Par, blk, cfg, x, pos: int, cache):
    kind = blk.kind
    if kind == "ssm":
        p, lcfg, norm, split, xs = _ssm_local(par, blk.ssm, cfg)
        state = par.cache_in(cache["state"],
                             Shard(1) if split else Replicate())
        conv = par.cache_in(cache["conv"], Replicate())
        din = cfg.d_inner
        conv_l = torch.cat([conv[..., xs], conv[..., din:]], dim=-1)
        d, c = ssm_mod.ssm_decode_delta(p, lcfg, par.local(x),
                                        {"state": state, "conv": conv_l},
                                        norm)
        out = _ssm_cache_out(par, c, split, lcfg)
        out = {"state": out["state"].redistribute(
                   par.mesh, cache["state"].placements),
               "conv": out["conv"].redistribute(
                   par.mesh, cache["conv"].placements)}
        return x + par.join(par.own(d, split)), out
    if kind == "rglru":
        p, gather, split = _rglru_local(par, blk.rec)
        hp, cp = ((Shard(1), Shard(2)) if split
                  else (Replicate(), Replicate()))
        c = {"h": par.cache_in(cache["h"], hp),
             "conv": par.cache_in(cache["conv"], cp)}
        d, c = rg.rglru_decode_delta(p, cfg, par.local(x), c, gather)
        x = x + par.join(par.own(d, split))
        c = {"h": par.cache_out(c["h"], hp, cache["h"]),
             "conv": par.cache_out(c["conv"], cp, cache["conv"])}
        return _mlp_residual(par, blk, cfg, x), c
    p, lcfg, kv, split, kv_split = _attn_local(par, blk.attn, cfg)
    pl = _attn_cache_pl(kv_split)
    ck, cv = (par.cache_in(cache[0], pl), par.cache_in(cache[1], pl))
    xl = par.local(x)
    if kind == "cross":
        d = cross_attention_decode_delta(p, lcfg, xl, ck, cv, kv)
    else:
        d, (ck, cv) = attention_decode_delta(
            p, lcfg, xl, (ck, cv), pos, tr.attention_window(cfg), kv)
    x = x + par.join(par.own(d, split))
    return (_mlp_residual(par, blk, cfg, x),
            (par.cache_out(ck, pl, cache[0]), par.cache_out(cv, pl,
                                                            cache[1])))

