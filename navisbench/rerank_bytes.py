"""The bytes a ``casr_rerank`` launch must move, and the search waves a
``--trace 1`` run traced: what ``casr_rerank_roofline`` is read from.

One launch reranks a wave of B lanes, each over a PQ-sorted pool of P
ids (``e_search``), and loads from the vector store only the rows CASR's
group loop reaches.  So its bytes depend on the data: the distinct rows
the wave loaded (the engine's ``rerank_rows_distinct`` count) come from
the wave's record.  A row that many lanes load is one row to move: at
20,000 vectors a wave's lanes load each row ~15 times, and counting
every load read the kernel at 138% of its bound on an H100.
"""
from __future__ import annotations


def casr_bytes(rows: int, lanes: int, pool: int, dim: int, k: int) -> int:
    """Bytes one ``casr_rerank`` launch must move, each once: the distinct
    ``rows`` it loaded [rows, D] f32, the lanes' queries [B, D] f32 and
    pool ids [B, P] i32 read; the exact distances [B, P] f32 and loaded
    flags [B, P] bool, the top k ids and distances [B, k] i32 + f32, and
    each lane's rows loaded (i64) and rounds (i32) written."""
    return (rows * dim * 4 + lanes * dim * 4 + lanes * pool * 4 +
            lanes * pool * 5 + lanes * k * 8 + lanes * 12)


def cell_shape(root, cell: str) -> tuple[int, int, int]:
    """The widths of the cell's configuration that fix a launch's bytes
    besides its rows: (D, P, k), P being ``e_search``."""
    from navisbench import harness
    bench = harness.load_benchmark(root)
    cfg = harness.load_config(root, bench,
                              harness.workload(bench, cell)["config"])
    return int(cfg["dim"]), int(cfg["e_search"]), int(cfg["k"])


def traced_waves(rec, launches: int) -> list | None:
    """The search waves of the traced part of the window: the first
    ``launches`` (``casr_rerank_kernel``'s count in the trace, one a wave)
    that began after the trace did, or None where the record has fewer
    or lacks their ``rerank_rows_distinct``."""
    if rec.trace_t0 is None or launches <= 0:
        return None
    ops = [op for op in rec.ops_of("search")
           if op["t0"] >= rec.trace_t0][:launches]
    if len(ops) < launches or not all(
            "rerank_rows_distinct" in op["timing"].get("counts", {})
            for op in ops):
        return None
    return ops
