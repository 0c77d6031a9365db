"""Assigned input shapes (identical for all 10 LM architectures).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a
seq_len-deep KV cache / recurrent state), NOT ``train_step``.
``long_500k`` is only run for sub-quadratic architectures (ssm/hybrid);
full-attention archs record SKIP(full attention) — see DESIGN.md §4.
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                        kind="decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def shapes_for(config) -> dict[str, ShapeConfig | None]:
    """The 4 assigned cells for an arch; None marks an assigned skip."""
    out: dict[str, ShapeConfig | None] = {}
    for name, s in SHAPES.items():
        if name == "long_500k" and not config.sub_quadratic:
            out[name] = None        # SKIP(full attention)
        else:
            out[name] = s
    return out
