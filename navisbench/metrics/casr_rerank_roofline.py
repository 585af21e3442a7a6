"""``casr_rerank``'s share of its roofline in the traced part of the
window, in %: the bytes its launches must move
(``rerank_bytes.casr_bytes`` of each traced wave's lanes and distinct
loaded rows, with the cell's D, P and k) at the H100's 3.35 TB/s, over
the profiler's device time of the kernel.  The kernel is bound by bytes:
it does three flops per four bytes of the rows it loads.  Nothing where
the trace has no launch or the waves lack the engine's
``rerank_rows_distinct``."""
from pathlib import Path

from navisbench.rerank_bytes import casr_bytes, cell_shape, traced_waves
from navisbench.tracing import PEAK_BYTES_S

ROOT = Path(__file__).resolve().parents[2]


def read(rec):
    t = rec.trace
    if not t:
        return None
    dev_s, launches = t["kernels"].get("casr_rerank_kernel", [0.0, 0])
    ops = traced_waves(rec, launches)
    if not dev_s or ops is None:
        return None
    dim, pool, k = cell_shape(ROOT, rec.cell)
    moved = sum(casr_bytes(op["timing"]["counts"]["rerank_rows_distinct"],
                           op["n"], pool, dim, k) for op in ops)
    return 100.0 * moved / PEAK_BYTES_S / dev_s
