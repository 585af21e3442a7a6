"""The search wave's stage spans and host reads at the ``deep96`` cell's
widths, on one NVIDIA GPU.

    python3 tools/wave_spans.py [--waves N] [--seed S]
    python3 tools/wave_spans.py --root DIR --save-state F --digest OUT
    python3 tools/wave_spans.py --load-state F --digest OUT
    python3 tools/wave_spans.py --compare A B

From the root of a checkout.  The first form builds the cell's index
(``navisbench/configs/deep96.json``, the benchmark's corpus), warms up,
then runs ``--waves`` ``search_many`` waves of 10,000 queries and prints
one JSON line a wave: the stage spans (lut, entry, traverse, mask,
rerank, replay), how much of ``wave_s - rerank_s`` the first four cover,
the host reads by stage and site, the loop counts, the rows CASR loads
a group (``rerank_rows`` over ``rerank_groups``) and the share of lane
steps that moved a lane.  One more wave runs under
``torch.cuda.set_sync_debug_mode("warn")``: its synchronising calls are
counted by source line and by whether ``search_many`` is on their stack,
and set against the recorder's reads less its ``timing`` syncs (which
the mode does not report).  Last, the recorder's own host cost a read,
a span and a count, and that times a wave's counts over ``wave_s``.

``--digest`` writes a SHA-256 of every answer, per-query I/O count, page
trace and cache table of the waves instead, for the checkout at
``--root`` (its ``src`` first on the path; the recorder's lines need the
checkout to have one); ``--save-state`` / ``--load-state`` share one
build between two checkouts in one call.  ``--compare`` says whether two
digests are equal, entry by entry.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
STAGES = ("lut", "entry", "traverse", "mask")


def _digest(t) -> str:
    import torch
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:24]


def _fields(obj, prefix: str) -> dict:
    import torch
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f"{prefix}.{f.name}"] = _digest(v)
    return out


def _cell(args, torch):
    from navisbench import cell as cell_mod
    from navisbench import corpus
    cfg = json.loads((HERE / "navisbench/configs/deep96.json").read_text())
    mix = json.loads((HERE / "navisbench/traffic/query.json").read_text())
    dev = torch.device("cuda")
    if args.load_state:
        from repro_torch.core import Engine
        codec, state = torch.load(args.load_state, weights_only=False)
        eng = Engine(cell_mod.engine_spec(cfg), device=dev)
        eng.set_codec(codec)
        gen = corpus.generator(args.seed, dev)
        mixture = corpus.mixture(corpus.generator(cfg["corpus"]["seed"], dev),
                                 cfg["corpus"], cfg["dim"])
    else:
        c = cell_mod.build(cfg, mix, args.seed, 0.0, dev, None)
        eng, state, gen, mixture = c.engine, c.state, c.gen, c.mixture
        if args.save_state:
            torch.save((eng.codec, state), args.save_state)
    qs = corpus.draw(gen, mixture, mix["wave_cap"] * (args.waves + 2))
    return eng, state, qs.reshape(args.waves + 2, mix["wave_cap"], -1)


def digest(args) -> dict:
    import torch
    from repro_torch.core import cache as cache_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    eng, state, waves = _cell(args, torch)
    traces = []
    inner = cache_mod.apply_traces

    def keep(st, tr):
        traces.append(tr)
        return inner(st, tr)

    cache_mod.apply_traces = keep
    out = {}
    for w in range(args.waves):
        ids, dists, stats, state = eng.search_many(state, waves[w])
        torch.cuda.synchronize()
        out[f"{w}.ids"], out[f"{w}.dists"] = _digest(ids), _digest(dists)
        for f, v in zip(stats._fields, stats):
            out[f"{w}.stats.{f}"] = _digest(v)
        out[f"{w}.trace"] = _digest(traces[-1])
        out.update(_fields(state.cache, f"{w}.cache"))
        out.update(_fields(state.ctr_search, f"{w}.ctr_search"))
    return out


def _recorder_cost(torch, spans) -> dict:
    """Host ns a clock stamp, a read (above the bare ``item``), a span and
    a count, each the median of 5 loops of 20,000."""
    t = torch.tensor(True)
    n = 20000

    def per(fn) -> float:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            fn()
            runs.append((time.perf_counter_ns() - t0) / n)
        return sorted(runs)[2]

    def bare():
        for _ in range(n):
            t.item()

    def routed():
        for _ in range(n):
            spans.read(t, "cost")

    def opened():
        for _ in range(n):
            with spans.span("cost"):
                pass

    def counted():
        for _ in range(n):
            spans.count("cost")

    def clock():
        for _ in range(n):
            time.perf_counter_ns()

    with spans.span("cost_root"):
        out = {"clock_ns": per(clock), "item_ns": per(bare),
               "read_ns": per(routed),
               "span_ns": per(opened), "count_ns": per(counted)}
    spans.take()
    out["read_over_item_ns"] = out["read_ns"] - out["item_ns"]
    return out


def _wave_line(w, tm, hops) -> dict:
    at = {s.name: s.t1 - s.t0 for s in tm["spans"]}
    stages = {k: at[k] for k in STAGES}
    outside_rerank = tm["wave_s"] - tm["rerank_s"]
    reads = tm["reads"]
    waits = {k: sum(s for key, (_, s) in reads.items()
                    if key.startswith(k + "/")) for k in at}
    return {"wave": w, "wave_s": tm["wave_s"], "rerank_s": tm["rerank_s"],
            "replay_s": tm["replay_s"], **{f"{k}_s": v
                                           for k, v in stages.items()},
            "covered": sum(stages.values()) / outside_rerank,
            "remainder_s": outside_rerank - sum(stages.values()),
            "wait_s": waits,
            "host_reads": sum(c for c, _ in reads.values()),
            "read_wait_s": waits["entry"] + waits["traverse"],
            "reads": reads, "counts": tm["counts"],
            "rerank_rows_a_group": (tm["counts"]["rerank_rows"] /
                                    tm["counts"]["rerank_groups"]),
            "active_lane_share": 100.0 * hops / tm["counts"]["traverse_lanes"]}


def spans_report(args) -> None:
    import torch
    from repro_torch import spans
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.cuda.get_device_name(0)
    eng, state, waves = _cell(args, torch)
    _, _, _, state = eng.search_many(state, waves[-1])      # warm-up
    torch.cuda.synchronize()
    lines = []
    for w in range(args.waves):
        h0 = int(state.ctr_search.hops)
        _, _, _, state = eng.search_many(state, waves[w])
        torch.cuda.synchronize()
        hops = int(state.ctr_search.hops) - h0
        line = _wave_line(w, eng.last_wave_timing, hops)
        lines.append(line)
        print(json.dumps({"device": dev, **line}), flush=True)

    caught, sites, stacks = [], {}, {}
    in_wave = [0]

    def keep(message, category, filename, lineno, file=None, line=None):
        caught.append(str(message))
        if "synchroniz" not in str(message):
            return
        key = f"{Path(filename).name}:{lineno}"
        sites[key] = sites.get(key, 0) + 1
        stack = traceback.extract_stack()[:-1]
        in_wave[0] += any(f.name == "search_many" for f in stack)
        if not filename.endswith("spans.py") and key not in stacks:
            # where a sync that bypasses the recorder came from
            stacks[key] = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                           for f in stack[-12:]]

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.search_many(state, waves[-2])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum(sites.values())
    reads = eng.last_wave_timing["reads"]
    routed = sum(n for k, (n, _) in reads.items() if not k.endswith("/timing"))
    timing = sum(n for k, (n, _) in reads.items() if k.endswith("/timing"))
    print(json.dumps({"device": dev, "sync_debug": {
        "reported": syncs, "in_search_many": in_wave[0],
        "host_reads": routed + timing,
        "timing_syncs": timing, "reads_less_timing": routed,
        "other_warnings": len(caught) - syncs, "by_line": sites,
        "bypassing": stacks}}),
        flush=True)

    cost = _recorder_cost(torch, spans)
    tm = eng.last_wave_timing
    n_reads = sum(n for n, _ in reads.values())
    # count calls: the entrance kernel's two (read at the mask's sync),
    # the rerank's three (read at its own), two a hop, one a redo
    c = tm["counts"]
    n_counts = 5 + 2 * c["traverse_iters"] + c["visited_redo"]
    per_wave_ns = (n_reads * cost["read_over_item_ns"] +
                   len(tm["spans"]) * cost["span_ns"] +
                   n_counts * cost["count_ns"])
    mean_wave = sum(ln["wave_s"] + ln["replay_s"] for ln in lines) / len(
        lines)
    print(json.dumps({"device": dev, "recorder_cost": {
        **cost, "reads": n_reads, "spans": len(tm["spans"]),
        "counts": n_counts, "per_wave_us": per_wave_ns / 1e3,
        "share_of_wave": per_wave_ns * 1e-9 / mean_wave}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2718281801)
    ap.add_argument("--save-state")
    ap.add_argument("--load-state")
    ap.add_argument("--digest")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(Path(p).read_text()) for p in args.compare)
        diff = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(json.dumps({"compared": len(a), "equal": not diff,
                          "differ": diff}))
        return 0 if not diff else 1
    for p in (HERE, args.root.resolve() / "src"):
        sys.path.insert(0, str(p))
    import torch
    import repro_torch
    print(f"wave_spans: repro_torch from {Path(repro_torch.__file__).parent}",
          file=sys.stderr)
    if not torch.cuda.is_available():
        print("wave_spans: no CUDA device", file=sys.stderr)
        return 3
    if args.digest:
        Path(args.digest).write_text(json.dumps(digest(args)))
        return 0
    spans_report(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
