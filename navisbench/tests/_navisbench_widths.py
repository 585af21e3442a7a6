"""A tiny checkout (``_navisbench_tiny``) in which a configuration may keep
its own widths: ``OWN`` gives such a configuration its cut of scale
alone (corpus size, headroom, build block), where the tiny checkout puts
every configuration at one 32-d shape.  The traffic stays the tiny
checkout's."""
from __future__ import annotations

import json
from pathlib import Path

import _navisbench_tiny as tiny

# fineweb768 at dim 768, r 48, pq_m 96, e_search 40, e_pos 64, max_hops
# 96 and 256 cache pages, over 100 vectors
OWN = {"fineweb768": dict(n_base=100, headroom=60, build_block=64)}


def make_root(dest: Path) -> Path:
    """The tiny checkout under ``dest``, with each configuration of
    ``OWN`` rewritten from its real file with its own cut."""
    root = tiny.make_root(dest)
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        if c["name"] in OWN:
            cfg = json.loads((tiny.REPO / c["file"]).read_text())
            cfg.update(OWN[c["name"]])
            (root / c["file"]).write_text(json.dumps(cfg))
    return root


def cells() -> list[str]:
    """The cells whose configuration keeps its widths here."""
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"] if w["config"] in OWN]
