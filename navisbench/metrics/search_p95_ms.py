"""95th percentile of every query issued in the window, each timed from
its issue to its answer (those answered after the window included)."""
import numpy as np


def read(rec):
    if rec.latencies_s is None or not rec.latencies_s.size:
        return None
    return float(np.percentile(rec.latencies_s, 95)) * 1e3
