"""A checkout root with the benchmark's cells cut to a size the CPU tests
hold: the real ``BENCHMARK.json``, loops, metrics and limits, with tiny
configurations and mixes in place of the real ones."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "navisbench"

TINY_CONFIG = dict(dim=32, r=12, pq_m=8, e_search=16, e_pos=24, max_hops=32,
                   cache_capacity_pages=64, n_base=300, headroom=1000,
                   build_block=64, build_e_pos=24)
TINY_CORPUS = dict(d_int=4, sigma_z=2.0, sigma_eps=0.05)
TINY_TRAFFIC = {"query": dict(clients=200, think_s=0.05, wave_cap=200,
                              query_pool=4096, recall_sample=256)}


def make_root(dest: Path) -> Path:
    """Write the tiny checkout under ``dest`` and return it."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pkg = dest / "navisbench"
    for sub in ("metrics", "loops"):
        shutil.copytree(PKG / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "checks"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY_CONFIG)
        cfg["corpus"].update(TINY_CORPUS)
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        mix = json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        mix.update(TINY_TRAFFIC[w["traffic"]])
        (pkg / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        shutil.copy(PKG / "checks" / f"{w['name']}.json",
                    pkg / "checks" / f"{w['name']}.json")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def _env() -> dict:
    """This environment with one thread and no inherited module path."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def drive(root: Path, scenarios: list[str], timeout: float = 240) -> dict:
    """Run ``scenarios`` (``cell:trace[:fault]``) one after another in one
    fresh process on the CPU; returns {scenario: {"rc", "result",
    "stderr"}}."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).with_name("_navisbench_drive.py")),
         str(root), *scenarios],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            out[rec["scenario"]] = rec
    return out
