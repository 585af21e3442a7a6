"""Build the same FineWeb-like corpus with the JAX reference and with the
PyTorch port on the CPU, and print each index's recall at three stages.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/width_parity.py \
        [--n 2993] [--blocks 64,512]

The width is the FineWeb-like cell's (dim 768, r 48, pq_m 96, e_search 40,
e_pos 64, max_hops 96).  ``--n`` must be 49 + a multiple of 64 (the
default 2993 = 49 + 46 * 64; 10033 = 49 + 156 * 64): the reference's
build bootstraps a clique of r + 1 = 49 vectors and then inserts blocks of
64, and with a partial last block it raises in ``graph._truncate`` at this
width (ROADMAP queue 3).  The port is built once per ``--blocks`` value.

Each build prints one JSON line with its seconds and recall@10 over 256
queries at the stages ``tools/build_block_cut.py`` reports: the PQ
ceiling (the share of the exact top 10 inside a full ADC scan's top 40,
with that build's own codec), the traversal's final pool of 40 (before
the exact rerank) and the engine's answer.  Expect tens of minutes at
N = 10,033: the port runs its plain kernels on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np
import torch

from repro.core import Engine as RefEngine
from repro.core import brute_force_topk, preset as ref_preset, recall_at_k
from repro.core import pq as ref_pq
from repro.data import make_clustered, query_stream
from repro_torch import random as jr
from repro_torch.core import Engine, check_invariants, preset
from repro_torch.core import pq as port_pq
from repro_torch.core import recall_at_k as port_recall

N_BOOT, BLOCK = 49, 64          # r + 1 clique, then the reference's blocks
DEPTH = 40                      # pool depth of the PQ ceiling (e_search)


def _hit_share(ids: np.ndarray, truth: np.ndarray) -> float:
    """Share of each query's exact top 10 found in its row of ``ids``."""
    return float((ids[:, :, None] == truth[:, None, :]).any(1).mean())


def _pq_ceiling(lut: np.ndarray, codes: np.ndarray, truth: np.ndarray):
    """Hit share of the top ``DEPTH`` of a full ADC scan (float32, in
    subspace order)."""
    d = np.zeros((lut.shape[0], codes.shape[0]), np.float32)
    for m in range(codes.shape[1]):
        d += lut[:, m, codes[:, m]]
    top = np.argsort(d, axis=1, kind="stable")[:, :DEPTH]
    return _hit_share(top, truth)


def _emit(**fields) -> None:
    print(json.dumps({"phase": "width_parity", **fields}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2993)
    ap.add_argument("--blocks", default="64,512")
    args = ap.parse_args()
    if (args.n - N_BOOT) % BLOCK:
        ap.error(f"--n must be {N_BOOT} + a multiple of {BLOCK}")
    key = jax.random.PRNGKey(123)
    vecs, _, cents = make_clustered(key, args.n, 768, n_clusters=24,
                                    noise=1.0)
    qs = query_stream(jax.random.fold_in(key, 1), cents, 256, noise=1.0)
    truth = np.array(brute_force_topk(qs, vecs, args.n, 10))
    kw = dict(dim=768, r=48, n_max=args.n + 1200, pq_m=96, e_search=40,
              e_pos=64, cache_capacity_pages=256, max_hops=96,
              buffer_max=256)

    t0 = time.perf_counter()
    ref = RefEngine(ref_preset("navis", **kw))
    ref_state = ref.build(jax.random.PRNGKey(42), vecs, build_block=BLOCK,
                          build_e_pos=64)
    build_s = time.perf_counter() - t0
    ids, _, _, _ = ref.search_many(ref_state, qs)
    pool = jax.jit(jax.vmap(lambda q: ref._search_core(
        ref_state, q, frozen=True)[4].pool_ids))(qs)
    lut = jax.vmap(lambda q: ref_pq.adc_lut(ref.codec, q))(qs)
    _emit(package="reference", n=args.n, build_block=BLOCK,
          build_s=build_s,
          pq_scan_recall_10_at_40=_pq_ceiling(
              np.asarray(lut), np.asarray(ref_state.codes[:args.n]), truth),
          pool_recall_10_at_40=_hit_share(np.asarray(pool), truth),
          recall_at_10=float(recall_at_k(ids, truth)))

    tq = torch.from_numpy(np.array(qs))
    for block in map(int, args.blocks.split(",")):
        t0 = time.perf_counter()
        eng = Engine(preset("navis", **kw), device="cpu")
        state = eng.build(jr.PRNGKey(42), torch.from_numpy(np.array(vecs)),
                          build_block=block, build_e_pos=64)
        build_s = time.perf_counter() - t0
        ids, _, _, _ = eng.search_many(state, tq)
        pool = eng._search_core(state, tq)[4].pool_ids
        lut = port_pq.adc_lut(eng.codec, tq)
        _emit(package="port", n=args.n, build_block=block, build_s=build_s,
              invariants=all(check_invariants(state.store).values()),
              pq_scan_recall_10_at_40=_pq_ceiling(
                  lut.numpy(), state.codes[:args.n].numpy(), truth),
              pool_recall_10_at_40=_hit_share(pool.numpy(), truth),
              recall_at_10=port_recall(ids, torch.from_numpy(truth)))


if __name__ == "__main__":
    main()
