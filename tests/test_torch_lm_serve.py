"""The port's RAG serving path against the reference's on the same weights:
``embed_tokens``, greedy ``generate`` (per-step logits and tokens) and the
driver ``python -m repro.launch.serve``'s printed text, with the
reference's ``LM.init(PRNGKey(0))`` given to both through
``convert.lm_params_from_reference``; and ``launch/serve.py``'s
retrieval recall against its exact top-k at nprobe 8, 64 and every list,
equal in both.

A generated token may differ from the reference's only at a near-tie: where
the port's top-2 logit gap at that step is within the logit tolerance and
the reference's token is the port's runner-up.
"""
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.serve as ref_serve  # noqa: E402
from repro.core.flat import exact_topk as ref_exact_topk  # noqa: E402
from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.archs import smoke as ref_smoke  # noqa: E402
from repro.models.embedder import embed_tokens as ref_embed_tokens  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro.serve.decode import _grow_attention_caches as ref_grow  # noqa: E402
from repro.serve.decode import generate as ref_generate  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.core.flat import exact_topk  # noqa: E402
from repro_torch.core.types import SearchParams  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.embedder import embed_tokens  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.serve.decode import (_grow_attention_caches,  # noqa: E402
                                      decode_steps, generate)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4            # f32 logits, as in tests/test_torch_models.py
EMBED_RTOL, EMBED_ATOL = 1e-5, 1e-6     # unit-norm vectors
CLI_TIMEOUT_S = 60


def _models(arch):
    """(reference LM, its params, the port's LM on the converted params)."""
    ref = RefLM(ref_smoke(REF_ARCHS[arch]))
    params = ref.init(jax.random.PRNGKey(0))
    cfg = smoke(ARCHS[arch])
    port = LM(cfg, seed=None, device="cpu")
    port.load_state_dict(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    port.requires_grad_(False)
    return ref, params, port


def _prompt(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return b


def _near_tie_at(logits: np.ndarray, want_token: int) -> bool:
    """The reference's token is the port's runner-up within LOGIT_TOL."""
    order = np.argsort(-logits, kind="stable")
    return (int(order[1]) == want_token
            and logits[order[0]] - logits[order[1]] <= LOGIT_TOL)


def _assert_tokens_agree(got, want, logits_of):
    """Rows equal up to their first differing step, which must be a
    near-tie of the port's logits (``logits_of(row, step)``)."""
    for row, (g, w) in enumerate(zip(got, want)):
        diff = np.flatnonzero(np.asarray(g) != np.asarray(w))
        if len(diff):
            step = int(diff[0])
            assert _near_tie_at(logits_of(row, step), int(w[step])), (
                f"row {row} differs at step {step} beyond a near-tie")


@pytest.mark.parametrize("arch", ["gemma-2b", "llama-3.2-vision-11b",
                                  "mamba2-1.3b"])
def test_embed_tokens_matches_the_reference(arch):
    ref, params, port = _models(arch)
    b = _prompt(port.cfg, 4, 32, seed=1)
    want = ref_embed_tokens(ref, params, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    got = embed_tokens(port, {k: torch.from_numpy(v) for k, v in b.items()})
    assert got.shape == want.shape == (4, port.cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=EMBED_RTOL, atol=EMBED_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b",
                                  "mamba2-1.3b", "dbrx-132b",
                                  "llama-3.2-vision-11b"])
def test_greedy_generate_matches_the_reference(arch):
    ref, params, port = _models(arch)
    n, S = 6, 10
    b = _prompt(port.cfg, 2, S, seed=2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_tokens = ref_generate(ref, params, jb, n_tokens=n)
    # the reference's logits at each step, fed its own tokens
    logits, caches = jax.jit(ref.prefill)(params, jb)
    caches = ref_grow(ref, caches, S + n)
    step = jax.jit(ref.decode_step)
    want_logits = []
    for t in range(n):
        want_logits.append(np.asarray(logits[:, -1]))
        bt = dict(jb)
        bt["tokens"] = jnp.asarray(want_tokens[:, t:t + 1], jnp.int32)
        logits, caches = step(params, bt, jnp.int32(S + t), caches)

    pb = {k: torch.from_numpy(v) for k, v in b.items()}
    steps = list(decode_steps(port, pb, n))
    got_logits = [lg.numpy() for lg, _ in steps]
    got_tokens = np.stack([tok.numpy() for _, tok in steps], axis=1)
    np.testing.assert_array_equal(generate(port, pb, n), got_tokens)
    _assert_tokens_agree(got_tokens, want_tokens,
                         lambda row, s: got_logits[s][row])
    # the logits agree up to the first step whose input token differed
    same = np.flatnonzero((got_tokens != want_tokens).any(0))
    upto = int(same[0]) + 1 if len(same) else n
    for s in range(upto):
        np.testing.assert_allclose(got_logits[s], want_logits[s],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_vlm_prompt_as_long_as_the_image_grows_its_cache():
    """A prompt of ``n_frontend_tokens`` tokens: the self-attention caches
    grow to the decode capacity (the reference's growth finds caches by
    shape and leaves these at the prompt's length, so its decode writes
    past them), and decode gives the teacher-forced logits."""
    _, _, port = _models("llama-3.2-vision-11b")
    cfg = port.cfg
    S, n = cfg.n_frontend_tokens, 4
    b = {k: torch.from_numpy(v) for k, v in _prompt(cfg, 2, S + n,
                                                     seed=4).items()}
    with torch.no_grad():
        full = port.logits(b).numpy()
    steps = list(decode_steps(port, {**b, "tokens": b["tokens"][:, :S]}, 1))
    _, caches = port.prefill({**b, "tokens": b["tokens"][:, :S]})
    grown = _grow_attention_caches(port, caches, S + n)
    for kind, c in zip(layer_kinds(cfg), grown):
        assert c[0].shape[1] == (S + n if kind == "attn" else S), kind
    np.testing.assert_allclose(steps[0][0].numpy(), full[:, S - 1],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for t in range(S, S + n):
        lt, grown = port.decode_step({**b, "tokens": b["tokens"][:, t:t + 1]},
                                     t, grown)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_sampled_decode_is_seeded():
    _, _, port = _models("gemma-2b")
    pb = {k: torch.from_numpy(v)
          for k, v in _prompt(port.cfg, 2, 8, seed=3).items()}
    a, b, c = (generate(port, pb, 5, temperature=1.0, seed=s)
               for s in (7, 7, 8))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and ((a >= 0) & (a < port.cfg.vocab)).all()
    assert not np.array_equal(a, c)


_REQUEST = re.compile(r"^request (\d+): docs (\[.*\]) -> (\[.*\])$")


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-1.3b"])
def test_serve_driver_prints_the_reference_text(arch, monkeypatch):
    argv = ["--arch", arch, "--requests", "4", "--tokens", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        ref_serve.main()
    # the same weights in both: the reference's init, converted
    _, _, port = _models(arch)
    args = port_serve.build_parser().parse_args(argv + ["--device", "cpu"])
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        run = port_serve.serve(port.cfg, port.state_dict(), args, "cpu")
    want, got = (s.getvalue().splitlines() for s in (ref_out, port_out))
    assert len(got) == len(want) == 2 + 4
    assert got[:2] == want[:2]          # index size, retrieval p50 and bytes
    for g, w in zip(got[2:], want[2:]):
        mg, mw = _REQUEST.match(g), _REQUEST.match(w)
        assert mg and mw and mg.group(1, 2) == mw.group(1, 2), (g, w)
        if mg.group(3) == mw.group(3):
            continue
        qid = int(mg.group(1))
        toks = [int(t) for t in mg.group(3)[1:-1].split(",")]
        want_toks = [int(t) for t in mw.group(3)[1:-1].split(",")]
        pb = {"tokens": torch.from_numpy(run.prompts[qid][None]).long()}
        if port.cfg.family == "vlm":
            pb["image_embeds"] = torch.zeros(
                (1, port.cfg.n_frontend_tokens, port.cfg.d_model))
        logits = [lg[0].numpy() for lg, _ in decode_steps(port, pb, 8)]
        _assert_tokens_agree([toks], [want_toks], lambda row, s: logits[s])


def _recalls(index, docs, qv, run_workload, search_params, exact, nprobes):
    """recall@4 of ``launch/serve.py``'s retrieval against the exact
    top-4, at each of ``nprobes`` (``None``: every list)."""
    gt, _ = exact(docs, qv, 4)
    out = {}
    for nprobe in nprobes:
        n = index.meta.n_lists if nprobe is None else nprobe
        rep = run_workload(index, qv, search_params(k=4, nprobe=n),
                           ref_serve.TOS, concurrency=len(qv))
        out[nprobe] = rep.recall_against(gt)
    return out


def test_rag_recall_matches_the_reference_at_every_nprobe(monkeypatch):
    """``launch/serve.py``'s index over 1,024 documents and 64 requests, on
    the reference's weights: the same list count, and recall@4 against
    each package's exact top-4 equal at nprobe 8 (serve's), 64 and
    every list, where it is 1.0 (generation is stubbed: only retrieval is
    under test)."""
    argv = ["--corpus", "1024", "--requests", "64", "--tokens", "1"]
    nprobes = (8, 64, None)
    seen = {}

    want_run, want_build = ref_serve.run_workload, ref_serve.ClusterIndex.build

    def build(docs, params):
        seen["docs"] = docs
        return want_build(docs, params)

    def capture(index, qv, params, storage, concurrency):
        seen.update(index=index, qv=qv)
        return want_run(index, qv, params, storage, concurrency=concurrency)

    monkeypatch.setattr(ref_serve.ClusterIndex, "build", staticmethod(build))
    monkeypatch.setattr(ref_serve, "run_workload", capture)
    monkeypatch.setattr(ref_serve, "generate",
                        lambda lm, params, b, n_tokens: np.zeros((1, 1), int))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(io.StringIO()):
        ref_serve.main()
    from repro.core.types import SearchParams as RefSearchParams
    want_lists = seen["index"].meta.n_lists
    want = _recalls(seen["index"], seen["docs"], seen["qv"], want_run,
                    RefSearchParams, ref_exact_topk, nprobes)

    _, _, port = _models("gemma-2b")
    monkeypatch.setattr(port_serve, "generate",
                        lambda lm, b, n_tokens: np.zeros((1, 1), int))
    args = port_serve.build_parser().parse_args(argv + ["--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        run = port_serve.serve(port.cfg, port.state_dict(), args, "cpu")
    got = _recalls(run.index, run.vecs, run.qv, port_serve.run_workload,
                   SearchParams,
                   lambda x, q, k: exact_topk(x, q, k, device="cpu"), nprobes)
    assert run.index.meta.n_lists == want_lists
    assert got == want, (got, want)
    print(f"recall@4 at nprobe 8 / 64 / all {want_lists} lists: {got}")
    assert got[None] == 1.0 and got[8] <= got[64] <= got[None]


def test_serve_cli_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma-2b", "--requests", "3", "--tokens", "4", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("indexed 128 docs")
    assert sorted(int(_REQUEST.match(ln).group(1)) for ln in lines[2:]) == [
        0, 1, 2]


def test_serve_cli_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.main(["--requests", "1", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(smoke(ARCHS["gemma-2b"]))


def test_musicgen_is_refused_as_in_the_reference():
    with pytest.raises(SystemExit, match="token archs"):
        port_serve.main(["--arch", "musicgen-medium", "--device", "cpu"])


def test_port_init_is_seeded():
    """One seed, one set of weights (drawn on the CPU before any move to
    the card); another seed, others."""
    cfg = dataclasses.replace(smoke(ARCHS["gemma-2b"]), n_layers=1)
    a, b = (LM(cfg, seed=0, device="cpu").state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = LM(cfg, seed=1, device="cpu").state_dict()
    assert not torch.equal(a["embed"], c["embed"])
