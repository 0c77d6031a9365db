"""Model / shape configuration dataclasses for the assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # --- attention details ---
    mlp: str = "swiglu"         # swiglu | geglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0       # sliding-window size for local attention
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0
    # --- VLM (cross-attention injection) ---
    cross_attn_period: int = 0  # one cross-attn layer per this many layers
    n_frontend_tokens: int = 0  # stub frontend sequence length (img/audio)
    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-local-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        embed = V * d * (1 if self.tie_embeddings else 2)
        total = embed
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "ssm":
                din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * din + 2 * N + H) + din * d + din  # in/out
                total += self.ssm_conv * (din + 2 * N)
                continue
            if kind == "rglru":
                w = self.lru_width or d
                total += d * w * 2 + w * d + 3 * w + self.ssm_conv * w
                total += self._mlp_params()
                continue
            # attention (self or self+cross)
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            total += attn * (2 if kind == "cross" else 1)
            if self.n_experts:
                gated = 2 if self.mlp in ("swiglu", "geglu") else 1
                expert = (gated + 1) * d * f
                total += self.n_experts * expert + d * self.n_experts
                total += self.n_shared_experts * expert
            else:
                total += self._mlp_params()
        return total

    def _mlp_params(self) -> int:
        gated = 2 if self.mlp in ("swiglu", "geglu") else 1
        return (gated + 1) * self.d_model * self.d_ff

    def n_active_params(self) -> int:
        """Active params per token (= n_params for dense)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        gated = 2 if self.mlp in ("swiglu", "geglu") else 1
        expert = (gated + 1) * d * f
        inactive = (self.n_experts - self.experts_per_token) * expert
        return self.n_params() - self.n_layers * inactive

    def layer_kind(self, i: int) -> str:
        """Layer i's block kind: attn | ssm | rglru | cross."""
        if self.family == "ssm":
            return "ssm"
        if self.block_pattern:
            return self.block_pattern[i % len(self.block_pattern)]
        if self.cross_attn_period and (
                i % self.cross_attn_period == self.cross_attn_period - 1):
            return "cross"
        return "attn"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
