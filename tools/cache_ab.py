"""Time the cache replay's stages of the PyTorch port on one GPU, for the
checkout at ``--root``: the FineWeb-like waves' ``replay_s``, the
sequential paths and FreshDiskANN's merge.

    python3 tools/cache_ab.py [--root DIR] [--n 20000] [--waves 4]
                              [--merge 64]

The corpus, spec and build are ``chip_smoke.py``'s FineWeb-like cell
(dim 768, r 48, pq_m 96, e_search 40, e_pos 64, max_hops 96, cache
capacity 256 pages, build_block 512) at ``--n`` vectors.  It runs
``--waves`` rounds of a search wave and an insert wave of 256, then 8
sequential inserts and 8 sequential searches, then FreshDiskANN adopting
the fresh build (``build(shared=)``), a buffered wave of ``--merge``
vectors and one ``merge``.  It prints one JSON line: each wave's
``last_wave_timing`` and wall seconds, each sequential operation's
seconds, the merge's seconds, and the card's name and power limit.
Only the engine's public API is used, so the same script times an older
checkout: unpack it with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent in one call.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

WAVE = 256


def _spec(preset, name: str, n_max: int):
    return preset(name, dim=768, r=48, n_max=n_max, pq_m=96, e_search=40,
                  e_pos=64, cache_capacity_pages=256, max_hops=96,
                  buffer_max=256)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--merge", type=int, default=64)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("cache_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import random as jr
    from repro_torch.core import Engine, preset
    from repro_torch.data import insert_stream, make_clustered, query_stream

    gen = torch.Generator(device="cuda").manual_seed(42)
    vecs, _, cents = make_clustered(gen, args.n, 768, n_clusters=24,
                                    scale=3.0, noise=1.0)
    n_max = args.n + 1200 + args.waves * WAVE
    eng = Engine(_spec(preset, "navis", n_max))
    state, build_s = _timed(torch, lambda: eng.build(
        jr.PRNGKey(42), vecs, build_block=512, build_e_pos=64))
    state0 = state
    out = {"root": str(root), "n": args.n, "build_s": build_s,
           "search_waves": [], "insert_waves": []}
    for _ in range(args.waves):
        qs = query_stream(gen, cents, WAVE)
        vs = insert_stream(gen, cents, WAVE, drift=0.2)
        (_, _, _, state), wall = _timed(
            torch, lambda: eng.search_many(state, qs))
        out["search_waves"].append({"wall_s": wall, **eng.last_wave_timing})
        (_, state), wall = _timed(torch, lambda: eng.insert_many(state, vs))
        out["insert_waves"].append({"wall_s": wall, **eng.last_wave_timing})
    vs = insert_stream(gen, cents, 8, drift=0.2)
    qs = query_stream(gen, cents, 8)
    out["insert_s"], out["search_s"] = [], []
    for i in range(8):
        (_, state, _), s = _timed(torch, lambda: eng.insert(state, vs[i]))
        out["insert_s"].append(s)
    for i in range(8):
        (_, _, _, state), s = _timed(torch, lambda: eng.search(state, qs[i]))
        out["search_s"].append(s)

    fd = Engine(_spec(preset, "freshdiskann", n_max))
    fd_state = fd.build(jr.PRNGKey(42), vecs, shared=eng.bundle(state0))
    _, fd_state = fd.insert_many(fd_state, insert_stream(
        gen, cents, args.merge, drift=0.2))
    (_, merged), out["merge_s"] = _timed(torch, lambda: fd.merge(fd_state))
    out["merged"] = merged.store.count - fd_state.store.count
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
