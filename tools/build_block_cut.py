"""Build the FineWeb-like index with the PyTorch port at several build-block
sizes on one GPU, and print each build's time and the recall it gives.

    python3 tools/build_block_cut.py [--n 20000] [--blocks 64,512]
                                     [--cap-s SECONDS]

The corpus, queries, spec and build settings are those of
``chip_smoke.py``'s FineWeb-like phase (dim 768, r 48, pq_m 96,
e_search 40, e_pos 64, max_hops 96, build_e_pos 64), at ``--n`` vectors.
For every block size it prints one JSON line: the build's seconds per
pass, ``check_invariants``, and recall@10 over 256 queries at three
stages: the PQ ceiling (a full ADC scan's top 40), the traversal's final
pool of 40 (before the exact rerank) and the engine's answer, the last
also with a 4x wider pool (e_search 160) on the same index.  A build that
runs past ``--cap-s`` seconds stops, and its line gives how far it got and
the insert pass's time projected at the rate so far.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import _pq_scan_recall  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import (Engine, brute_force_topk,  # noqa: E402
                              check_invariants, preset, recall_at_k)
from repro_torch.data import make_clustered, query_stream  # noqa: E402

N_QUERIES = 256


class _OutOfTime(Exception):
    pass


def _spec(n: int, e_search: int = 40):
    return preset("navis", dim=768, r=48, n_max=n + 1200, pq_m=96,
                  e_search=e_search, e_pos=64, cache_capacity_pages=256,
                  max_hops=96, buffer_max=256)


def _pool_recall(eng, state, qs, truth) -> float:
    """Share of the exact top 10 inside the traversal's final pool."""
    pool = eng._search_core(state, qs)[4].pool_ids.long()
    return float((pool[:, :, None] == truth[:, None, :].long())
                 .any(1).float().mean())


def run_block(n: int, block: int, cap_s: float | None, vecs, qs, truth):
    eng = Engine(_spec(n))
    marks = {}
    t0 = time.perf_counter()

    def progress(stage, done, total):
        marks[stage] = (done, time.perf_counter() - t0)
        if cap_s is not None and marks[stage][1] > cap_s:
            raise _OutOfTime

    try:
        state = eng.build(jr.PRNGKey(42), vecs, build_block=block,
                          build_e_pos=64, progress=progress)
    except _OutOfTime:
        done, secs = marks.get("insert", (0, 0.0))
        return {"n": n, "build_block": block, "finished": False,
                "stopped_after_s": time.perf_counter() - t0,
                "insert_done": done, "insert_s_so_far": secs,
                "refine_reached": "refine" in marks,
                "insert_pass_s_projected": secs * n / max(done, 1)}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    insert_s = marks["insert"][1]
    ids = eng.search_many(state, qs)[0]
    wide = Engine(_spec(n, e_search=160))
    wide.set_codec(eng.codec)
    wide_ids = wide.search_many(state, qs)[0]
    return {"n": n, "build_block": block, "finished": True,
            "build_s": build_s, "insert_s": insert_s,
            "refine_s": marks["refine"][1] - insert_s,
            "invariants": all(check_invariants(state.store).values()),
            "pq_scan_recall_10_at_40": _pq_scan_recall(
                torch, eng, state, qs, truth, n, 40),
            "pool_recall_10_at_40": _pool_recall(eng, state, qs, truth),
            "recall_at_10": recall_at_k(ids, truth),
            "recall_at_10_e_search_160": recall_at_k(wide_ids, truth)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--blocks", default="64,512")
    ap.add_argument("--cap-s", type=float, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("build_block_cut: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(42)
    vecs, _, cents = make_clustered(gen, args.n, 768, n_clusters=24,
                                    scale=3.0, noise=1.0)
    qs = query_stream(gen, cents, N_QUERIES)
    truth = brute_force_topk(qs, vecs, args.n, 10)
    for block in map(int, args.blocks.split(",")):
        rec = run_block(args.n, block, args.cap_s, vecs, qs, truth)
        print(json.dumps({"phase": "build_block_cut", **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
