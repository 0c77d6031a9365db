"""The 10 assigned architectures, exact dims from the assignment sheet.

Each also gets a ``smoke()`` reduced config of the same family for CPU
tests (same block structure, tiny widths).  ``[source; verified-tier]``
annotations are carried in ``notes``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

MAMBA2_1P3B = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    notes="SSD (state-space duality) [arXiv:2405.21060; unverified]")

RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256, mlp="geglu", local_window=2048,
    block_pattern=("rglru", "rglru", "attn"), lru_width=2560,
    notes="RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf]")

GEMMA_2B = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=256_000, head_dim=256, mlp="geglu", tie_embeddings=True,
    notes="GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]")

STARCODER2_7B = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, mlp="gelu",
    notes="GQA kv=4, RoPE [arXiv:2402.19173; hf]")

INTERNLM2_20B = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, mlp="swiglu",
    notes="GQA [arXiv:2403.17297; hf]")

QWEN3_32B = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151_936, head_dim=128, qk_norm=True, mlp="swiglu",
    rope_theta=1_000_000.0,
    notes="qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]")

LLAMA32_VISION_11B = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128_256, mlp="swiglu", rope_theta=500_000.0,
    cross_attn_period=5, n_frontend_tokens=1601,
    notes="cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; "
          "unverified]; vision frontend is a stub (precomputed patch "
          "embeddings via input_specs)")

MUSICGEN_MEDIUM = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, mlp="gelu", n_frontend_tokens=0,
    notes="decoder-only over EnCodec tokens [arXiv:2306.05284; hf]; "
          "EnCodec frontend is a stub (precomputed frame embeddings)")

DBRX_132B = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100_352, mlp="swiglu", n_experts=16, experts_per_token=4,
    notes="16 experts top-4, fine-grained [hf:databricks/dbrx-base; "
          "unverified]")

MOONSHOT_16B_A3B = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163_840, mlp="swiglu", n_experts=64, experts_per_token=6,
    n_shared_experts=2,
    notes="kimi/moonlight, 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]")

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    MAMBA2_1P3B, RECURRENTGEMMA_2B, GEMMA_2B, STARCODER2_7B, INTERNLM2_20B,
    QWEN3_32B, LLAMA32_VISION_11B, MUSICGEN_MEDIUM, DBRX_132B,
    MOONSHOT_16B_A3B,
]}


def smoke(config: ModelConfig) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests."""
    kw: dict = dict(
        name=config.name + "-smoke",
        n_layers=min(config.n_layers, 4 if config.block_pattern else 3),
        d_model=64,
        vocab=256,
        dtype="float32",
        remat=False,
    )
    if config.block_pattern:
        kw["n_layers"] = len(config.block_pattern) + 1   # pattern + tail
    if config.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(config.n_kv_heads, 2) or 1
        if config.n_kv_heads == config.n_heads:
            kw["n_kv_heads"] = 4
        kw["head_dim"] = 16
    if config.d_ff:
        kw["d_ff"] = 128
    if config.n_experts:
        kw["n_experts"] = 4
        kw["experts_per_token"] = 2
        kw["d_ff"] = 32
        # drop-free capacity so prefill/decode equal teacher forcing
        kw["capacity_factor"] = 8.0
    if config.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 16
    if config.lru_width:
        kw["lru_width"] = 64
    if config.local_window:
        kw["local_window"] = 16
    if config.cross_attn_period:
        kw["n_layers"] = 5
        kw["n_frontend_tokens"] = 12
    return dataclasses.replace(config, **kw)


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]
