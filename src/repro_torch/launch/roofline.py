"""Three-term roofline analysis of a dry-run cell.

Counterpart of ``repro.launch.roofline``, with the H100's constants
(:mod:`repro_torch.hw`, the data sheet's SXM part at 700 W):

    compute    = FLOPs_global / (chips * 989e12 FLOP/s bf16)
    memory     = bytes_global / (chips * 3.35e12 B/s HBM)
    collective = NVLink bytes / 450e9 B/s + network bytes / 50e9 B/s
                 (per device)

The reference prices every collective at one ICI link rate.  A node here
joins ``NODE_CARDS`` (8) cards all to all over NVLink, and nodes talk over
one 400 Gb/s NIC a card, so a collective is priced by its group: one whose
ranks all sit in one node moves at the NVLink rate, one whose group spans
nodes at the network rate.

The FLOP and byte numerators are the reference's analytic model
(:func:`analytic_flops`, :func:`analytic_bytes`, copied).  Collective bytes
come from the cell's one sharded step, where the reference parses the
compiled HLO text: either from records made as each collective is called
(:func:`call_record`, the dry-run's way) or from a ``torch.profiler``
chrome trace of the step (:func:`collective_records`).  The step runs
eagerly, so either holds every collective that executed, each loop
iteration included: the reference's while-loop trip-count walk
(HloCostAnalysis counts a scan body once) has nothing to correct here.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import hw
from repro_torch.launch.mesh import NODE_CARDS

_H100 = hw.PEAKS[0][0]
HW = dict(
    peak_flops=hw.card_bf16_peak(_H100),     # dense bf16 FLOP/s per card
    hbm_Bps=hw.card_peaks(_H100)[1],         # HBM bandwidth per card
    nvlink_Bps=hw.card_links(_H100)[0],      # inside a node, each way
    net_Bps=hw.card_links(_H100)[1],         # across nodes, each way
)

# profiler dtype names (``Input type``) -> bytes an element
_DTYPE_BYTES = {
    "double": 8, "float": 4, "c10::Half": 2, "c10::BFloat16": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "long int": 8, "int": 4, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
    "c10::complex<double>": 16,
}

# collective op (profiler name without its namespace) -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_tensor": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
# the argument that holds the group size, where the record has one
_SIZE_ARG = {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 2}
# the argument that holds the tensor operand where it is not the first (the
# ``c10d`` ops that take the output first)
_OPERAND_ARG = {"allgather_": 1, "_allgather_base_": 1, "reduce_scatter_": 1,
                "_reduce_scatter_base_": 1, "alltoall_": 1,
                "alltoall_base_": 1}
_GROUP_TAG = "c10d_group "


def _shape_bytes(dtype: str, dims) -> int:
    """Bytes of a tensor of profiler dtype name ``dtype`` and ``dims``."""
    n = 1
    for d in dims:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _events(trace) -> list[dict]:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def _kind(name: str) -> str | None:
    ns, _, op = name.partition("::")
    if ns not in ("_c10d_functional", "c10d"):
        return None
    return _KINDS.get(op)


def _operand_bytes(e: dict) -> int:
    """Bytes of the collective's tensor operand: the first argument, or the
    input where a ``c10d`` op takes its output first.  A tensor list
    carries no dtype in the record, so its elements count as float32."""
    args = e.get("args", {})
    dims, types = args.get("Input Dims", []), args.get("Input type", [])
    i = _OPERAND_ARG.get(e["name"].partition("::")[2], 0)
    if i >= len(dims):
        return 0
    d, t = dims[i], types[i] if i < len(types) else ""
    if t == "TensorList":
        return sum(_shape_bytes("float", x) for x in d)
    return _shape_bytes(t, d) if t in _DTYPE_BYTES else 0


def _within(inner: dict, outer: dict) -> bool:
    return (inner.get("pid") == outer.get("pid")
            and inner.get("tid") == outer.get("tid")
            and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def collective_records(trace) -> list[dict]:
    """``{"kind", "bytes", "group", "nodes"}`` of every collective of a chrome
    trace (a path or the loaded dict), one each.

    A collective is recorded once by each layer it passes (the functional
    op, the mode stack, the ``c10d`` op): a record nested in another
    collective's on the same thread is that one's duplicate and is dropped.
    ``wait_tensor`` and the backends' own events are not collectives.
    ``group`` is the group's size, ``nodes`` the nodes its ranks span: from
    the :func:`annotate_groups` event around the collective (or inside its
    outermost record), else ``nodes`` is None and ``group`` what the
    record's ``Concrete Inputs`` say (None if nothing).
    """
    evs = _events(trace)
    colls = sorted((e for e in evs if _kind(e["name"])),
                   key=lambda e: (e["ts"], -e["dur"]))
    tags = sorted((e for e in evs if e["name"].startswith(_GROUP_TAG)),
                  key=lambda e: e["ts"])
    starts = [t["ts"] for t in tags]
    out, kept = [], []
    for e in colls:
        if any(_within(e, k) for k in kept[-8:]):
            continue
        kept.append(e)
        group = nodes = None
        # the tag around it starts last before it, the one inside it first
        # after its start
        i = bisect.bisect_right(starts, e["ts"])
        for t in tags[max(0, i - 1):i + 1]:
            if _within(e, t) or _within(t, e):
                fields = dict(f.split("=") for f in
                              t["name"][len(_GROUP_TAG):].split())
                group, nodes = int(fields["size"]), int(fields["nodes"])
                break
        if group is None:
            op = e["name"].partition("::")[2]
            conc = e.get("args", {}).get("Concrete Inputs", [])
            i = _SIZE_ARG.get(op)
            if i is not None and i < len(conc) and conc[i]:
                group = int(conc[i])
        out.append({"kind": _kind(e["name"]), "bytes": _operand_bytes(e),
                    "group": group, "nodes": nodes})
    return out


def _records(trace) -> list[dict]:
    """``trace``'s records: parsed from a chrome trace (a path or the loaded
    dict), or the list of records itself (:func:`call_record`'s)."""
    return trace if isinstance(trace, list) else collective_records(trace)


def collective_bytes(trace) -> dict[str, int]:
    """Per-kind operand bytes (per device) of a chrome trace or records."""
    out: dict[str, int] = {}
    for r in _records(trace):
        out[r["kind"]] = out.get(r["kind"], 0) + r["bytes"]
    return out


def count_collectives(trace) -> dict[str, int]:
    """Per-kind count of a chrome trace's or records' collectives."""
    out: dict[str, int] = {}
    for r in _records(trace):
        out[r["kind"]] = out.get(r["kind"], 0) + 1
    return out


def link_of(group: int | None, nodes: int | None) -> str:
    """``"nvlink"`` for a group inside one node, else ``"network"``.  Without
    the nodes a group spans, a group of at most ``NODE_CARDS`` ranks counts
    as one node's (the production mesh's model axis is a node's cards); a
    group of unknown size counts as spanning nodes."""
    if nodes is not None:
        return "nvlink" if nodes == 1 else "network"
    return "nvlink" if group is not None and group <= NODE_CARDS \
        else "network"


def link_bytes(trace) -> dict[str, int]:
    """Operand bytes (per device) by link, ``{"nvlink": .., "network": ..}``,
    of a chrome trace or records."""
    out = {"nvlink": 0, "network": 0}
    for r in _records(trace):
        out[link_of(r["group"], r["nodes"])] += r["bytes"]
    return out


def _group_of(args) -> "dist.ProcessGroup | None":
    for a in args:
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a)
            except (KeyError, RuntimeError, ValueError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject):      # a c10d op's group
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
    return None


def _span(args) -> tuple[int, int] | None:
    """(size, nodes its ranks span) of the group a collective is called
    with, ``NODE_CARDS`` consecutive ranks a node; None if not found."""
    pg = _group_of(args)
    if pg is None:
        return None
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), len({r // NODE_CARDS for r in ranks})


def group_tag(func, args) -> str | None:
    """The tag event's name for a collective op ``func`` called with
    ``args``: its group's size and the nodes its ranks span; None for any
    other op."""
    if not _kind(f"{func.namespace}::{func._opname}"):
        return None
    span = _span(args)
    return None if span is None else \
        f"{_GROUP_TAG}size={span[0]} nodes={span[1]}"


def call_record(func, args) -> dict | None:
    """The record of a collective op ``func`` called with ``args``, as
    :func:`collective_records` reads it from a trace (``kind``, operand
    ``bytes`` at the operand's own dtype, ``group``, ``nodes``); None for
    any other op."""
    op = func._opname
    kind = _kind(f"{func.namespace}::{op}")
    if kind is None:
        return None
    group, nodes = _span(args) or (None, None)
    if group is None and _SIZE_ARG.get(op, len(args)) < len(args):
        group = int(args[_SIZE_ARG[op]])
    operand = args[_OPERAND_ARG.get(op, 0)] if args else ()
    nbytes = sum(t.numel() * t.element_size()
                 for t in pytree.tree_leaves(operand)
                 if isinstance(t, torch.Tensor))
    return {"kind": kind, "bytes": nbytes, "group": group, "nodes": nodes}


class _GroupTags(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tag = group_tag(func, list(args) + list(kwargs.values()))
        if tag is None:
            return func(*args, **kwargs)
        with torch.profiler.record_function(tag):
            return func(*args, **kwargs)


@contextlib.contextmanager
def annotate_groups():
    """Wrap every collective in a profiler event that names its group's size
    and the nodes its ranks span (``NODE_CARDS`` consecutive ranks a node):
    ``all_reduce`` and the ``c10d`` ops carry no group size in their own
    records.  Enter it inside ``torch.profiler.profile`` (and inside
    ``FakeTensorMode``)."""
    with _GroupTags():
        yield


@dataclasses.dataclass
class Roofline:
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    model_flops: float            # 6ND (train) / 2ND (inference), active
    raw_cost_analysis: dict = dataclasses.field(default_factory=dict)
    # per-device collective bytes by link; bytes not split here are priced
    # at the network rate
    coll_link_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / HW["peak_flops"]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HW["hbm_Bps"]

    @property
    def collective_s(self) -> float:
        nv = self.coll_link_bytes.get("nvlink", 0.0)
        net = self.coll_bytes_per_device - nv
        return nv / HW["nvlink_Bps"] + net / HW["net_Bps"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / FLOPs_global: remat and redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips * peak * roofline step time)."""
        denom = self.chips * HW["peak_flops"] * self.step_s
        return self.model_flops / denom if denom else 0.0

    def report(self) -> dict:
        return dict(
            chips=self.chips,
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            bottleneck=self.bottleneck,
            step_s=self.step_s,
            model_flops=self.model_flops,
            hlo_flops_global=self.flops_per_device * self.chips,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_mfu=self.mfu,
            coll_breakdown=self.coll_breakdown,
            coll_link_bytes=self.coll_link_bytes,
            raw_cost_analysis=self.raw_cost_analysis,
        )


# ---------------------------------------------------------------------------
# Analytic cost model (matmul-exact FLOPs; parameter/activation HBM-traffic
# model), the reference's, copied.  These are the per-cell roofline
# numerators; the FLOP counter's and the memory tracker's numbers are kept
# beside them in ``raw_cost_analysis`` for cross-checking.
# ---------------------------------------------------------------------------

def _layer_flops_per_token(cfg, kind: str, S_ctx: float, train: bool,
                           decode: bool) -> float:
    """Forward FLOPs per token for one layer of ``kind``.

    S_ctx: attended context length (chunked attention computes all
    (masked) blocks, so the score/AV term uses the full S, or
    window+chunk for the banded local path).
    """
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    f = cfg.d_ff
    gated = cfg.mlp in ("swiglu", "geglu")
    mlp_f = (6 if gated else 4) * d * f

    if kind == "ssm":
        din, N, Hs, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_head_dim)
        proj = 2 * d * (2 * din + 2 * N + Hs) + 2 * din * d
        conv = 2 * cfg.ssm_conv * (din + 2 * N)
        if decode:
            ssd = 4 * Hs * P * N                    # state update + readout
        else:
            Q = cfg.ssm_chunk
            ssd = Q * (2 * N + 2 * Hs * P) + 4 * Hs * P * N
        return proj + conv + ssd
    if kind == "rglru":
        w = cfg.lru_width or d
        rec = 2 * d * w * 2 + 2 * w * w * 2 + 2 * w * d \
            + 2 * cfg.ssm_conv * w + 10 * w
        return rec + mlp_f
    # attention kinds
    qkvo = 2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d
    if kind == "cross":
        scores = 4 * cfg.n_frontend_tokens * H * hd
        if decode:
            qkvo = 2 * d * H * hd + 2 * H * hd * d   # K/V cached
        return qkvo + scores + mlp_f
    scores = 4 * S_ctx * H * hd
    ffn = mlp_f
    if cfg.n_experts:
        # router + K routed experts (+ shared); dispatch is gather/scatter
        ffn = 2 * d * cfg.n_experts \
            + cfg.experts_per_token * cfg.capacity_factor * mlp_f \
            + cfg.n_shared_experts * mlp_f
    return qkvo + scores + ffn


TRAIN_FLOP_FACTOR = 4.0


def analytic_flops(cfg, shape) -> float:
    """Total executed FLOPs (global, forward+backward as appropriate)."""
    from repro_torch.models.layers import (ATTN_CHUNK, CAUSAL_BLOCK_UNROLL,
                                           CHUNKED_ATTN_THRESHOLD)
    from repro_torch.models.transformer import layer_kinds
    S = shape.seq_len
    decode = shape.kind == "decode"
    train = shape.kind == "train"
    tokens = shape.global_batch if decode else shape.tokens
    total = 0.0
    for kind in layer_kinds(cfg):
        if decode:
            s_ctx = (min(cfg.local_window, S)
                     if (cfg.block_pattern and kind == "attn")
                     else S)
        elif cfg.block_pattern and kind == "attn" and cfg.local_window:
            s_ctx = min(S, cfg.local_window + ATTN_CHUNK)
        else:
            s_ctx = S
            nq = S // ATTN_CHUNK
            if (S > CHUNKED_ATTN_THRESHOLD
                    and 1 < nq <= CAUSAL_BLOCK_UNROLL):
                # causal-blocked path computes only (nq+1)/(2nq) of blocks
                s_ctx = S * (nq + 1) / (2 * nq)
        total += _layer_flops_per_token(cfg, kind, s_ctx, train, decode)
    total += 2 * cfg.d_model * cfg.vocab           # head matmul
    total *= tokens
    if train:
        # stack: fwd + remat recompute + bwd = 4x fwd under full remat
        # (nested attention checkpointing adds ~1 more fwd on the score
        # terms — folded in); 3x when dots are saved (set by dryrun
        # --remat dots via TRAIN_FLOP_FACTOR)
        return TRAIN_FLOP_FACTOR * total
    return total


def analytic_bytes(cfg, shape, chips: int) -> float:
    """Per-device HBM traffic model (documented, coarse):

    * params: read for fwd (+recompute +bwd) as bf16 casts of f32 masters,
      optimizer read/write p/m/v f32 (train);
    * activations: ~12 (B,S,d)-sized tensor read/writes per layer + MLP/
      attention internals, bf16;
    * decode: full KV-cache / recurrent-state read + write-back of one slot.
    """
    n_params = cfg.n_params()
    p_dev = n_params * 4.0 / chips
    L = cfg.n_layers
    d = cfg.d_model
    act_width = d + cfg.n_heads * cfg.resolved_head_dim \
        + (cfg.experts_per_token * cfg.capacity_factor
           if cfg.n_experts else 1) * cfg.d_ff * 0.5
    if shape.kind == "decode":
        tokens_dev = shape.global_batch / min(chips, shape.global_batch)
        cache = 0.0
        for kind in (cfg.layer_kind(i) for i in range(L)):
            if kind in ("attn", "cross"):
                ctx = (min(cfg.local_window, shape.seq_len)
                       if cfg.block_pattern else shape.seq_len)
                cache += 2 * ctx * cfg.n_kv_heads * cfg.resolved_head_dim \
                    * 2.0
            elif kind == "ssm":
                cache += cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state \
                    * 4.0
            elif kind == "rglru":
                cache += (cfg.lru_width or d) * 4.0
        cache_dev = cache * shape.global_batch / chips * (
            1.0 if shape.global_batch >= 16 else chips / 16)
        return p_dev + cache_dev + tokens_dev * L * act_width * 2 * 4
    tokens_dev = shape.tokens / chips
    act = tokens_dev * L * (12 * d + 2 * act_width) * 2.0
    mult = 3.0 if shape.kind == "train" else 1.0     # fwd+recompute+bwd
    opt = 20.0 * p_dev if shape.kind == "train" else 0.0
    return mult * act + 3.0 * p_dev + opt


def model_flops_for(cfg, shape) -> float:
    """6*N_active*tokens (train) / 2*N_active*tokens (inference).

    N counts matmul-participating params: the embedding table is a
    gather (0 FLOPs), so vocab*d is subtracted once (for tied embeddings
    the same table IS the head matmul, which stays counted).
    """
    n = cfg.n_active_params() - cfg.vocab * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch      # decode: one token per seq


def analyze(chips: int, cfg, shape, trace=None, *,
            flop_count: float | None = None,
            peak_bytes: float | None = None) -> Roofline:
    """Roofline terms for one cell.

    FLOPs/bytes numerators come from the analytic model, as in the
    reference.  Collective bytes come from the cell's sharded step:
    ``trace`` is its chrome trace or its collectives' records (none
    without one).  ``raw_cost_analysis`` keeps
    the cross-checks: ``flop_count`` (one rank's ``FlopCounterMode``
    total) and ``peak_bytes`` (one rank's peak from the memory tracker).
    """
    coll = collective_bytes(trace) if trace is not None else {}
    links = link_bytes(trace) if trace is not None else {}
    raw = {}
    if flop_count is not None:
        raw["flop_counter_per_device"] = float(flop_count)
    if peak_bytes is not None:
        raw["memory_peak_per_device"] = float(peak_bytes)
    return Roofline(
        chips=chips,
        flops_per_device=analytic_flops(cfg, shape) / chips,
        bytes_per_device=analytic_bytes(cfg, shape, chips),
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops=model_flops_for(cfg, shape),
        raw_cost_analysis=raw,
        coll_link_bytes=links,
    )
