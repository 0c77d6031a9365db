"""End-to-end RAG serving on the PyTorch port: LM embeddings -> cloud
vector index -> retrieve -> prefill -> decode.

The port's counterpart of ``examples/rag_serving.py``, with its printed
lines: a reduced gemma-family model embeds 256 documents and generates 8
tokens for each of 4 queries, conditioned on the documents it retrieved,
with the retrieval I/O priced by the TOS simulator.  The LM, the index
build's closure (``l2_topk``) and generation run on ``--device`` (default:
the card; without one this raises, so pass ``--device cpu`` for the plain
PyTorch versions).  The weights are drawn on the CPU from seed 0 by a
``torch.Generator`` (not ``jax.random``) and moved, so the card and the
CPU run the same weights; ``main(params=...)`` takes any state dict
instead.

    PYTHONPATH=src python examples/torch/rag_serving.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS, smoke
from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.types import ClusterIndexParams, SearchParams
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.serve.decode import generate
from repro_torch.serving.engine import run_workload
from repro_torch.storage.spec import TOS


@torch.no_grad()
def main(argv=None, params: dict | None = None) -> dict:
    """Run the example; ``params``: the LM's state dict (default: drawn
    from seed 0).  Returns what it built and generated (``docs``,
    ``doc_vecs``, ``query_vecs``, ``index``, ``report`` and ``tokens``,
    one row a retrieval record)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the LM, the index build and generation "
                         "run (default: cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke(ARCHS["gemma-2b"])
    if params is None:
        params = LM(cfg, seed=0, device="cpu").state_dict()
    lm = LM(cfg, seed=None, device=device)
    lm.load_state_dict(params)
    lm.requires_grad_(False)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=64, seed=0))

    def embed(tokens):
        b = {"tokens": torch.from_numpy(tokens).to(device, torch.long)}
        return lm._backbone(b).float().mean(1).cpu().numpy()

    # ---- corpus: 256 synthetic documents, embedded by the LM ------------
    print("embedding 256 documents with the LM backbone...")
    docs = np.concatenate(
        [pipe.batch(s)["tokens"] for s in range(4)])          # (256, 32)
    doc_vecs = []
    for s in range(0, len(docs), 64):
        v = embed(docs[s:s + 64])
        doc_vecs.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    doc_vecs = np.concatenate(doc_vecs).astype(np.float32)

    # ---- index on simulated cloud storage --------------------------------
    print("building cloud vector index over document embeddings...")
    idx = ClusterIndex.build(doc_vecs, ClusterIndexParams(
        centroid_frac=0.2, num_replica=4), device=device)

    # ---- serve: retrieve + generate --------------------------------------
    query_batch = pipe.batch(100)["tokens"][:4]               # 4 queries
    qv = embed(query_batch)
    qv = (qv / np.linalg.norm(qv, axis=1, keepdims=True)).astype(np.float32)

    rep = run_workload(idx, qv, SearchParams(k=4, nprobe=8), TOS,
                       concurrency=4)
    print(f"retrieval on {TOS.name}: p50 "
          f"{rep.latency_percentile(50)*1e3:.1f} ms, "
          f"{rep.mean_bytes_read/1e3:.1f} KB/query")

    tokens = []
    for i, rec in enumerate(rep.records):
        top = rec.ids[rec.ids >= 0][:2]
        # prompt = retrieved docs + query tokens
        ctx = np.concatenate([docs[d] for d in top] + [query_batch[i]])
        prompt = torch.from_numpy(ctx[None, -64:]).to(device, torch.long)
        out = generate(lm, {"tokens": prompt}, n_tokens=8)
        tokens.append(out[0])
        print(f"query {i}: retrieved docs {list(top)}, "
              f"generated tokens {out[0].tolist()}")

    print("done.")
    return {"docs": docs, "doc_vecs": doc_vecs, "query_vecs": qv,
            "index": idx, "report": rep, "tokens": np.stack(tokens)}


if __name__ == "__main__":
    main()
