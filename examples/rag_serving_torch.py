"""RAG serving on the PyTorch/CUDA port: an assigned-architecture LM embeds
"documents" and queries (mean-pooled final hidden states), the NAVIS
engine indexes the documents and retrieves the top 5 for each query.  It
runs on the GPU; ``--device cpu`` runs on the host instead.

    PYTHONPATH=src python examples/rag_serving_torch.py --arch qwen2-0.5b
    PYTHONPATH=src python examples/rag_serving_torch.py --device cpu

The counterpart of ``examples/rag_serving.py`` (the JAX package), with its
settings: the smoke configuration, 512 documents of 32 tokens in 8
batches of 64, navis at r 16, ``e_search`` 32, ``e_pos`` 40,
``pq_m = min(32, dim // 2)``, a 64-page cache and ``max_hops`` 48.  Its
token draws (``fold_in`` of ``PRNGKey(0)``) go through the port's
bit-exact threefry, so both packages embed the same tokens; the weights
come from a ``torch.Generator`` seeded with 0.
"""
import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch import random as jr
from repro_torch.core import Engine, brute_force_topk, preset, recall_at_k
from repro_torch.models import transformer as T

N_BATCHES, DOCS_PER_BATCH, DOC_LEN, QUERY_LEN = 8, 64, 32, 32
TOP = 5


@torch.inference_mode()
def embed_queries(cfg, params, token_batches) -> torch.Tensor:
    """Mean-pooled last-hidden-state embeddings, float32 [N, D]."""
    outs = [T.forward(cfg, params, tokens).mean(dim=1)
            for tokens in token_batches]
    return torch.cat(outs).float()


def document_tokens(cfg, key, device) -> list:
    """The reference's 8 batches of [64, 32] document tokens."""
    return [jr.randint(jr.fold_in(key, i), (DOCS_PER_BATCH, DOC_LEN), 0,
                       cfg.vocab_size).to(device=device, dtype=torch.int32)
            for i in range(N_BATCHES)]


def query_tokens(cfg, key, n: int, device) -> torch.Tensor:
    """``n`` queries of 32 tokens (the reference draws 4)."""
    return jr.randint(jr.fold_in(key, 1234), (n, QUERY_LEN), 0,
                      cfg.vocab_size).to(device=device, dtype=torch.int32)


def index_spec(dim: int, n_docs: int):
    return preset("navis", dim=dim, r=16, n_max=n_docs + 64, e_search=32,
                  e_pos=40, pq_m=min(32, dim // 2), cache_capacity_pages=64,
                  max_hops=48)


def build_index(docs: torch.Tensor, key, device):
    """The navis index over the document embeddings."""
    eng = Engine(index_spec(docs.shape[1], docs.shape[0]), device=device)
    return eng, eng.build(jr.fold_in(key, 99), docs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(C.ARCH_IDS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "host")
    dev = torch.device(args.device)
    cfg = C.get_arch(args.arch).smoke
    key = jr.PRNGKey(0)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    print(f"embedding {N_BATCHES * DOCS_PER_BATCH} documents with "
          f"{args.arch} (smoke config, d={cfg.d_model}) on {dev}...")
    docs = embed_queries(cfg, params, document_tokens(cfg, key, dev))
    eng, state = build_index(docs, key, dev)
    print(f"indexed {state.store.count} docs")

    # serve: embed a query batch, retrieve the top 5 docs of each
    t0 = time.time()
    q_emb = embed_queries(cfg, params, [query_tokens(cfg, key, 4, dev)])
    ids, dists, _, state = eng.search_batch(state, q_emb)
    print(f"retrieved in {time.time() - t0:.2f}s")
    for i in range(q_emb.shape[0]):
        print(f"  query {i}: docs {ids[i][:TOP].tolist()} "
              f"(d={[round(float(x), 1) for x in dists[i][:TOP]]})")
    truth = brute_force_topk(q_emb, docs, docs.shape[0], TOP)
    recall = recall_at_k(ids[:, :TOP], truth)
    print(f"recall@{TOP} against brute force: {recall:.3f}")
    return {"docs": docs, "queries": q_emb, "ids": ids, "dists": dists,
            "recall": recall}


if __name__ == "__main__":
    main()
