"""The port's LM stack against ``repro.models`` on the same weights.

Every case converts the reference's ``LM.init(PRNGKey(0))`` with
``convert.lm_params_from_reference`` and feeds both packages the same
numpy inputs: ``logits``, ``loss``, ``prefill`` (logits and caches) and
four ``decode_step``s for each arch's ``smoke()`` config; the port's own
prefill/decode consistency (``tests/test_models_smoke.py``); the configs'
parameter counts; bf16 activations; MoE with dropped tokens; SSD and
RG-LRU at a length that is not a multiple of the chunk; and
``_sdpa_chunked`` on the cases of ``tests/test_attention_chunked.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.archs import smoke as ref_smoke  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro.models.transformer import unit_structure  # noqa: E402
from repro.serve.decode import _grow_attention_caches as ref_grow  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.decode import _grow_attention_caches  # noqa: E402

RTOL = ATOL = 1e-4          # f32: sums in another order than XLA's
BF16_TOL = 2e-2             # bf16 activations: one bf16 rounding apart
B, S, N_DECODE = 2, 32, 4


def _batch(cfg, seq, seed=0, n_tokens=None):
    """Inputs from ``seed``; tokens from the first ``n_tokens`` ids of the
    vocabulary (default: all of it)."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, seq, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, n_tokens or cfg.vocab,
                                       (B, seq)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _cut(cfg, batch, lo, hi):
    out = {k: v for k, v in batch.items() if k != "labels"}
    key = "frames" if cfg.family == "audio" else "tokens"
    out[key] = batch[key][:, lo:hi]
    return out


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _layer_caches(cfg, caches):
    """The reference's caches as one list of arrays per layer, in the
    port's layer order (unit slot j of repetition r is layer r*len+j)."""
    unit, n_rep, tail = unit_structure(cfg)
    per_layer = [None] * cfg.n_layers
    for j, c in enumerate(caches["unit"]):
        for r in range(n_rep):
            per_layer[r * len(unit) + j] = jax.tree.map(lambda a: a[r], c)
    for i, c in enumerate(caches["tail"]):
        per_layer[n_rep * len(unit) + i] = c
    return [[np.asarray(a) for a in jax.tree.leaves(c)] for c in per_layer]


def _port_caches(caches):
    """Copies of the port's caches (decode writes into them in place)."""
    out = []
    for c in caches:
        leaves = [c[k] for k in sorted(c)] if isinstance(c, dict) else list(c)
        out.append([t.float().numpy().copy() for t in leaves])
    return out


class Pair:
    """One config's reference LM and the port's LM on its converted
    weights, and the reference's outputs on this file's inputs."""

    def __init__(self, cfg, seq=S, seed=0, n_tokens=None):
        self.cfg = cfg
        self.ref = RefLM(cfg)
        self.params = self.ref.init(jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, self.params)
        pcfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})
        self.port = LM(pcfg, seed=None, device="cpu")
        self.port.load_state_dict(lm_params_from_reference(pcfg, np_params))
        self.port.requires_grad_(False)
        self.seq = seq
        self.batch = _batch(cfg, seq, seed, n_tokens)
        self._ref_out = None

    def ref_out(self):
        """Reference logits, loss, prefill (logits, per-layer caches) on
        seq - 4 positions and the logits of 4 teacher-forced decode steps."""
        if self._ref_out is None:
            cfg, lm, params, b = self.cfg, self.ref, self.params, self.batch
            logits = np.asarray(jax.jit(lm.logits)(params, _jx(b)))
            loss = float(jax.jit(lm.loss)(params, _jx(b)))
            plen = self.seq - N_DECODE
            lp, caches = jax.jit(lm.prefill)(params, _jx(_cut(cfg, b, 0,
                                                              plen)))
            layer_caches = _layer_caches(cfg, caches)
            caches = ref_grow(lm, caches, self.seq)
            step = jax.jit(lm.decode_step)
            steps = []
            for t in range(plen, self.seq):
                lt, caches = step(params, _jx(_cut(cfg, b, t, t + 1)),
                                  jnp.int32(t), caches)
                steps.append(np.asarray(lt[:, 0]))
            self._ref_out = dict(logits=logits, loss=loss,
                                 prefill=np.asarray(lp[:, 0]),
                                 caches=layer_caches, steps=steps)
        return self._ref_out

    def port_out(self):
        cfg, lm, b = self.cfg, self.port, self.batch
        with torch.no_grad():
            logits = lm.logits(_pt(b)).numpy()
            loss = float(lm.loss(_pt(b)))
        plen = self.seq - N_DECODE
        lp, caches = lm.prefill(_pt(_cut(cfg, b, 0, plen)))
        layer_caches = _port_caches(caches)
        caches = _grow_attention_caches(lm, caches, self.seq)
        steps = []
        for t in range(plen, self.seq):
            lt, caches = lm.decode_step(_pt(_cut(cfg, b, t, t + 1)), t, caches)
            steps.append(lt[:, 0].numpy())
        return dict(logits=logits, loss=loss, prefill=lp[:, 0].numpy(),
                    caches=layer_caches, steps=steps)


_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(ref_smoke(REF_ARCHS[arch]))
    return _PAIRS[arch]


def _assert_matches(got, want, tol):
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol, atol=tol)
    np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=tol,
                               atol=tol)
    assert len(got["caches"]) == len(want["caches"])
    for layer, (g, w) in enumerate(zip(got["caches"], want["caches"])):
        assert [a.shape for a in g] == [a.shape for a in w], layer
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b.astype(np.float32), rtol=tol,
                                       atol=tol, err_msg=f"layer {layer}")
    for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_matches_the_reference(arch):
    pair = _pair(arch)
    _assert_matches(pair.port_out(), pair.ref_out(), RTOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_consistency(arch):
    """Decode after prefill gives the teacher-forced forward's logits at the
    same positions (the reference's test, on the port alone)."""
    pair = _pair(arch)
    cfg, lm = pair.port.cfg, pair.port
    batch = _pt(pair.batch)
    with torch.no_grad():
        full = lm.logits(batch).numpy()
    plen = S - 4
    lp, caches = lm.prefill(_pt(_cut(cfg, pair.batch, 0, plen)))
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, plen - 1],
                               rtol=2e-2, atol=2e-2)
    caches = _grow_attention_caches(lm, caches, S)
    for t in range(plen, S):
        lt, caches = lm.decode_step(_pt(_cut(cfg, pair.batch, t, t + 1)), t,
                                    caches)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t], rtol=3e-2,
                                   atol=3e-2)


def test_n_params_sane():
    approx = {
        "mamba2-1.3b": (0.9e9, 2.0e9),
        "gemma-2b": (2.0e9, 3.3e9),
        "starcoder2-7b": (6e9, 9e9),
        "internlm2-20b": (17e9, 24e9),
        "qwen3-32b": (28e9, 38e9),
        "dbrx-132b": (110e9, 145e9),
        "moonshot-v1-16b-a3b": (24e9, 32e9),
    }
    for name, (lo, hi) in approx.items():
        n = ARCHS[name].n_params()
        assert lo <= n <= hi, (name, n)
        assert n == REF_ARCHS[name].n_params()


def test_moe_active_params():
    cfg = ARCHS["moonshot-v1-16b-a3b"]
    act = cfg.n_active_params()
    assert act < 0.4 * cfg.n_params()
    assert 2e9 <= act <= 5e9


def test_port_params_have_the_reference_shapes():
    """The port's own init (seed 0) draws every parameter the reference
    has, with its shape; only the draws differ."""
    for arch in sorted(ARCHS):
        cfg = smoke(ARCHS[arch])
        want = lm_params_from_reference(cfg, jax.tree.map(
            np.asarray, _pair(arch).params))
        got = LM(cfg, seed=0, device="cpu").state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}, arch
        assert all(v.dtype == torch.float32 for v in got.values())


def test_bf16_activations_match_the_reference():
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS["gemma-2b"]),
                              dtype="bfloat16")
    pair = Pair(cfg)
    _assert_matches(pair.port_out(), pair.ref_out(), BF16_TOL)


@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
def test_moe_with_dropped_tokens_matches_the_reference(arch):
    cfg = dataclasses.replace(ref_smoke(REF_ARCHS[arch]),
                              capacity_factor=1.25)
    # three distinct tokens: same-token positions pick the same experts,
    # so some experts overflow their capacity
    pair = Pair(cfg, n_tokens=3)
    got = pair.port_out()
    _assert_matches(got, pair.ref_out(), RTOL)
    # tokens were dropped: the drop-free capacity gives other logits
    free = _pair(arch).port
    with torch.no_grad():
        drop_free = free.logits(_pt(pair.batch)).numpy()
    assert np.abs(drop_free - got["logits"]).max() > 1e-3


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_scans_at_a_length_off_the_chunk_match_the_reference(arch):
    cfg = ref_smoke(REF_ARCHS[arch])
    seq = 21                  # prefill 17, ssm_chunk and local_window 16
    assert seq % cfg.ssm_chunk and (seq - N_DECODE) % cfg.ssm_chunk
    pair = Pair(cfg, seq=seq, seed=1)
    _assert_matches(pair.port_out(), pair.ref_out(), RTOL)


def _qkv(B_, S_, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B_, S_, H, hd), (B_, S_, KV, hd), (B_, S_, KV, hd))]


@pytest.mark.parametrize("B_,S_,H,KV,hd,window,chunk", [
    (2, 256, 4, 4, 16, 0, 64),          # test_chunked_matches_full
    (2, 256, 8, 2, 16, 0, 64),
    (2, 256, 4, 1, 16, 0, 64),
    (1, 256, 4, 2, 16, 32, 64),         # test_chunked_local_window_...
    (1, 256, 4, 2, 16, 64, 64),
    (1, 256, 4, 2, 16, 100, 64),
    (2, 64, 4, 4, 16, 0, 64),           # test_single_chunk_degenerate
    (1, 256, 4, 2, 16, 0, 16),          # 16 q chunks: past the unroll
], ids=["mha", "gqa", "mqa", "w32", "w64", "w100", "single", "scan"])
def test_sdpa_chunked_matches_the_reference(B_, S_, H, KV, hd, window,
                                            chunk):
    q, k, v = _qkv(B_, S_, H, KV, hd, seed=S_ + H + window + chunk)
    want = np.asarray(ref_layers._sdpa_chunked(
        *(jnp.asarray(a) for a in (q, k, v)), KV, window=window,
        chunk=chunk))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = layers._sdpa_chunked(qt, kt, vt, KV, window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    full = layers._sdpa(qt, kt, vt, layers.causal_mask(S_, S_, window), KV)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)
