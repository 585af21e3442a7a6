"""Quickstart on the PyTorch/CUDA port: build a NAVIS index, search it,
insert into it.  It runs on the GPU; ``--device cpu`` runs the plain
versions on the host instead (a small ``--n`` keeps that quick).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 400

The counterpart of ``examples/quickstart.py`` (the JAX package).
"""
import argparse
import time

import torch

from repro_torch import random as jr
from repro_torch.core import Engine, brute_force_topk, preset, recall_at_k
from repro_torch.data import insert_stream, make_clustered, query_stream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--n", type=int, default=2000, help="corpus size")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "host")
    dev = torch.device(args.device)
    n = args.n

    # a clustered corpus standing in for text embeddings
    gen = torch.Generator(device=dev).manual_seed(0)
    vecs, _, cents = make_clustered(gen, n, 64, n_clusters=16)
    queries = query_stream(gen, cents, 50)

    # NAVIS = decoupled layout + CASR + dynamic entrance + NAVIS-cache
    spec = preset("navis", dim=64, r=16, n_max=n + 500, e_search=40,
                  e_pos=48, pq_m=32, cache_capacity_pages=128, max_hops=64)
    eng = Engine(spec, device=dev)

    t0 = time.time()
    state = eng.build(jr.PRNGKey(2), vecs)
    print(f"built {state.store.count} vertices on {dev} in "
          f"{time.time() - t0:.0f}s (entrance graph: {state.ent.count} "
          f"entries)")

    # --- search: one wave of 50 concurrent queries -------------------------
    ids, dists, stats, state = eng.search_many(state, queries)
    truth = brute_force_topk(queries, vecs, n, 10)
    print(f"recall@10 = {recall_at_k(ids, truth):.3f}, mean I/O = "
          f"{float(stats.read_requests.double().mean()):.1f} requests / "
          f"{float(stats.read_bytes.double().mean()) / 1024:.0f} KiB per "
          f"query")

    # --- an insert wave ------------------------------------------------------
    new = insert_stream(gen, cents, 20)
    istats, state = eng.insert_many(state, new)
    print(f"inserted 20 vectors: mean "
          f"{float(istats.read_requests.double().mean()):.0f} reads, "
          f"{float(istats.write_requests.double().mean()):.0f} writes each; "
          f"corpus now {state.store.count}")

    # the freshly inserted vectors are immediately searchable
    ids2, _, _, state = eng.search(state, new[0])
    print("nearest to first inserted vector:", ids2[:3].tolist(),
          "(expect", state.store.count - 20, "first)")
    return recall_at_k(ids, truth), ids2[0].item(), state.store.count - 20


if __name__ == "__main__":
    main()
