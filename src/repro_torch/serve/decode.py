"""Greedy/sampled autoregressive generation on top of prefill/decode_step.

Counterpart of ``repro.serve.decode``.  A sampled draw (temperature > 0)
comes from a ``torch.Generator`` seeded with ``seed``, not from
``jax.random`` as in the reference; greedy decoding is the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.transformer import attention_window, layer_kinds


def _grow_attention_caches(lm, caches: list, capacity: int) -> list:
    """Pad the self-attention layers' prefill-length KV caches up to the
    decode capacity (a local layer's up to its window); the cross layers'
    image K/V and the recurrent states stay as they are."""
    window = attention_window(lm.cfg)
    cap = min(capacity, window) if window else capacity
    out = []
    for kind, c in zip(layer_kinds(lm.cfg), caches):
        if kind == "attn" and cap > c[0].shape[1]:
            pad = (0, 0, 0, 0, 0, cap - c[0].shape[1])
            c = (F.pad(c[0], pad), F.pad(c[1], pad))
        out.append(c)
    return out


def decode_steps(lm, batch, n_tokens: int, temperature: float = 0.0,
                 seed: int = 0):
    """Prefill the prompt, then decode ``n_tokens`` greedily (or sampled).

    Yields, for each new token, ``(logits (B, V) f32, token (B,))``: the
    logits it was chosen from (the prefill's for the first) and the token.
    The decode step that follows a token runs when the next item is asked
    for, as in the reference's loop.
    """
    prompt = batch["tokens"]
    B, S = prompt.shape
    capacity = S + n_tokens
    logits, caches = lm.prefill(batch)
    caches = _grow_attention_caches(lm, caches, capacity)
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=logits.device).manual_seed(seed)
    for t in range(n_tokens):
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = last.argmax(dim=-1)            # the first maximum
        yield last, tok
        bt = dict(batch)
        bt["tokens"] = tok[:, None].to(prompt.dtype)
        logits, caches = lm.decode_step(bt, S + t, caches)


def generate(lm, batch, n_tokens: int, temperature: float = 0.0,
             seed: int = 0) -> np.ndarray:
    """Prefill the prompt then decode ``n_tokens`` greedily (or sampled).

    batch: the prompt inputs (tokens (B, S) etc.) on the LM's device.
    Returns (B, n_tokens) int64.
    """
    out = [tok.cpu().numpy()
           for _, tok in decode_steps(lm, batch, n_tokens, temperature, seed)]
    return np.stack(out, axis=1)
