"""Build the same FineWeb-like corpus with the JAX reference and with the
PyTorch port on the CPU, and print each index's recall@10.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/width_parity.py

The width is the FineWeb-like cell's (dim 768, r 48, pq_m 96, e_search 40,
e_pos 64, max_hops 96).  The default N = 2993 = 49 + 46 * 64 fills the
reference's last insert block exactly: with a partial block the
reference's build raises in ``graph._truncate`` at this width (ROADMAP
queue 3).  The port is built once per ``--blocks`` value.  Expect
minutes: the port runs its plain kernels on the CPU.
"""
from __future__ import annotations

import argparse
import time

import jax
import numpy as np
import torch

from repro.core import Engine as RefEngine
from repro.core import brute_force_topk, preset as ref_preset, recall_at_k
from repro.data import make_clustered, query_stream
from repro_torch import random as jr
from repro_torch.core import Engine, check_invariants, preset
from repro_torch.core import recall_at_k as port_recall


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2993)
    ap.add_argument("--blocks", default="64,512")
    args = ap.parse_args()
    key = jax.random.PRNGKey(123)
    vecs, _, cents = make_clustered(key, args.n, 768, n_clusters=24,
                                    noise=1.0)
    qs = query_stream(jax.random.fold_in(key, 1), cents, 256, noise=1.0)
    truth = brute_force_topk(qs, vecs, args.n, 10)
    kw = dict(dim=768, r=48, n_max=args.n + 1200, pq_m=96, e_search=40,
              e_pos=64, cache_capacity_pages=256, max_hops=96,
              buffer_max=256)

    t0 = time.perf_counter()
    ref = RefEngine(ref_preset("navis", **kw))
    ref_state = ref.build(jax.random.PRNGKey(42), vecs, build_block=64,
                          build_e_pos=64)
    ids, _, _, _ = ref.search_many(ref_state, qs)
    print(f"reference block 64: recall@10 {float(recall_at_k(ids, truth))}"
          f" ({time.perf_counter() - t0:.0f} s)", flush=True)

    for block in map(int, args.blocks.split(",")):
        t0 = time.perf_counter()
        eng = Engine(preset("navis", **kw), device="cpu")
        state = eng.build(jr.PRNGKey(42), torch.from_numpy(np.array(vecs)),
                          build_block=block, build_e_pos=64)
        ids, _, _, _ = eng.search_many(state, torch.from_numpy(np.array(qs)))
        recall = port_recall(ids, torch.from_numpy(np.array(truth)))
        ok = all(check_invariants(state.store).values())
        print(f"port block {block}: recall@10 {recall}, invariants {ok} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
