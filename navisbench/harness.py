"""What the benchmark finds by name, and what a run hands its readers.

``BENCHMARK.json`` at the root of a checkout names every cell, and each
cell a configuration and a traffic mix.  The harness finds:

- a configuration at the ``file`` its ``configs`` entry names;
- a traffic mix at ``navisbench/traffic/<traffic>.json``, whose ``loop``
  names a driver loop at ``navisbench/loops/<loop>.py``;
- a metric, end-to-end or per-layer, at ``navisbench/metrics/<name>.py``:
  a module with ``read(record) -> float | None`` (None: nothing to read,
  and the metric is left out of the line);
- a cell's limits for the comparison that decides ``correct`` at
  ``navisbench/checks/<workload>.json``.

So a later change adds a cell, a mix or a metric by adding files and
entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "navisbench"
# top-level module names that must not be loaded in a run: the JAX package
# the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchmarkError(Exception):
    """A cell, file or entry that the benchmark cannot find or read."""


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise BenchmarkError(f"cannot read {path}: {exc}") from exc


def load_benchmark(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchmarkError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def load_config(root: Path, bench: dict, name: str) -> dict:
    return _json(root / _named(bench["configs"], name, "config")["file"])


def load_traffic(root: Path, name: str) -> dict:
    return _json(root / PACKAGE / "traffic" / f"{name}.json")


def load_limits(root: Path, cell: str) -> dict:
    return _json(root / PACKAGE / "checks" / f"{cell}.json")


def _module(path: Path, label: str):
    if not path.is_file():
        raise BenchmarkError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}._found.{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(root: Path, name: str):
    return _module(root / PACKAGE / "loops" / f"{name}.py",
                   "loop_" + name.replace(".", "_"))


def load_metric(root: Path, name: str):
    return _module(root / PACKAGE / "metrics" / f"{name}.py",
                   "metric_" + name.replace(".", "_").replace("-", "_"))


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``): a
    metric with a ``workloads`` key where that lists the cell; one without
    it where the cell reports the end-to-end metric it moves (an
    end-to-end metric without it: in every cell)."""
    e2e = bench["end_to_end"]

    def reports(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        if kind == "end_to_end":
            return True
        return reports(_named(e2e, m["moves"], "end-to-end metric"))

    return [m for m in bench[kind] if reports(m)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Span:
    """A host-clock interval (``time.perf_counter`` seconds)."""
    name: str
    t0: float
    t1: float


@dataclasses.dataclass
class Record:
    """What a run measured, for the metrics' readers.

    ``ops``: one dict per engine call in the window (``kind``: the call,
    ``n`` lanes, ``timing``: the engine's ``last_wave_timing``);
    ``counters``: the engine's search and insert I/O counters' change over
    the window, by field; ``latencies_s``: one per query issued in the
    window, from its issue to its answer (closed-loop cells); ``trace``:
    the profiled part of a ``--trace 1`` run (:mod:`navisbench.tracing`),
    which began at ``trace_t0``.
    """
    cell: str
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    ops: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    n_answered: int = 0
    latencies_s: np.ndarray | None = None
    recall: float | None = None
    trace: dict | None = None
    trace_t0: float | None = None

    def ops_of(self, kind: str) -> list[dict]:
        return [op for op in self.ops if op["kind"] == kind]

    def timed_ops(self, kind: str) -> list[dict]:
        """The calls of ``kind`` that ended before the trace began: once
        the profiler has run, every launch of the process costs more, so
        the spans of the calls after it read the profiler too."""
        end = float("inf") if self.trace_t0 is None else self.trace_t0
        return [op for op in self.ops_of(kind) if op["t1"] <= end]
