"""Serving driver: retrieval-augmented generation.

Counterpart of ``repro.launch.serve``.  Pipeline: the LM embeds the corpus
-> cloud vector index (simulated TOS) -> per-request retrieve -> prefill ->
decode.  ``main`` runs the arch's ``smoke()`` config, as the reference
does; :func:`serve` is the same pipeline for any config and parameters.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 4 --tokens 8 [--device cpu]

The LM, the index build's closure and the retrieval run on the card unless
``--device cpu`` is given (without a card and without it, this raises).
The parameters are drawn on the CPU from seed 0 and moved, so the card and
the CPU run the same weights.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS, smoke as smoke_cfg
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.types import ClusterIndexParams, SearchParams
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.serve.decode import generate
from repro_torch.serving.engine import run_workload
from repro_torch.storage.spec import TOS


@dataclasses.dataclass
class ServeRun:
    """What one :func:`serve` run built and answered."""
    lm: LM
    docs: np.ndarray          # (corpus, 32) document tokens
    vecs: np.ndarray          # (corpus, d_model) unit-norm embeddings
    index: ClusterIndex
    qtok: np.ndarray          # (requests, 32) query tokens
    qv: np.ndarray            # (requests, d_model) query embeddings
    report: object            # run_workload's report
    prompts: dict             # qid -> the generation's prompt tokens
    outputs: dict             # qid -> the generated tokens


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--corpus", type=int, default=128)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="where the LM, the index build and retrieval run "
                         "(default: cuda; raises without a card)")
    return ap


def _inputs(cfg: ModelConfig, tokens: np.ndarray, device) -> dict:
    b = {"tokens": torch.from_numpy(np.asarray(tokens)).to(device,
                                                           torch.long)}
    if cfg.family == "vlm":
        b["image_embeds"] = torch.zeros(
            (len(tokens), cfg.n_frontend_tokens, cfg.d_model), device=device)
    return b


@torch.no_grad()
def serve(cfg: ModelConfig, params, args, device) -> ServeRun:
    """Embed ``args.corpus`` documents, index them, retrieve for
    ``args.requests`` queries and generate ``args.tokens`` tokens for each,
    printing the reference's lines.  ``params``: the LM's state (a
    ``state_dict``), loaded onto ``device``."""
    device = torch.device(device)
    lm = LM(cfg, seed=None, device=device)
    lm.load_state_dict(params)
    lm.requires_grad_(False)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=64))

    def embed(tokens):
        v = lm._backbone(_inputs(cfg, tokens, device)).float().mean(1)
        return v.cpu().numpy()

    docs = np.concatenate([pipe.batch(s)["tokens"]
                           for s in range(args.corpus // 64)])
    vecs = []
    for s in range(0, len(docs), 64):
        v = embed(docs[s:s + 64])
        vecs.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    vecs = np.concatenate(vecs).astype(np.float32)
    index = ClusterIndex.build(vecs, ClusterIndexParams(
        centroid_frac=0.2, num_replica=4), device=device)
    print(f"indexed {len(vecs)} docs "
          f"({index.meta.index_bytes/1e3:.0f} KB on {TOS.name})")

    qtok = pipe.batch(999)["tokens"][: args.requests]
    qv = embed(qtok)
    qv = (qv / np.linalg.norm(qv, axis=1, keepdims=True)).astype(np.float32)
    rep = run_workload(index, qv, SearchParams(k=args.k, nprobe=8), TOS,
                       concurrency=args.requests)
    print(f"retrieval p50 {rep.latency_percentile(50)*1e3:.1f} ms, "
          f"{rep.mean_bytes_read/1e3:.1f} KB/query")

    prompts, outputs = {}, {}
    for rec in rep.records:
        top = rec.ids[rec.ids >= 0][:2]
        ctx = np.concatenate([docs[d] for d in top]
                             + [qtok[rec.qid]])[-64:]
        out = generate(lm, _inputs(cfg, ctx[None], device),
                       n_tokens=args.tokens)
        prompts[rec.qid], outputs[rec.qid] = ctx, out[0]
        print(f"request {rec.qid}: docs {list(top)} -> {out[0].tolist()}")
    return ServeRun(lm, docs, vecs, index, qtok, qv, rep, prompts, outputs)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_cfg(ARCHS[args.arch])
    if cfg.family in ("audio",):
        raise SystemExit("serve driver targets token archs; musicgen's "
                         "frontend is a stub (see examples/)")
    params = LM(cfg, seed=0, device="cpu").state_dict()
    serve(cfg, params, args, device)


if __name__ == "__main__":
    main()
