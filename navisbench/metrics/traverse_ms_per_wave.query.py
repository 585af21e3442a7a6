"""Mean ms of a search wave's entry, traversal and tombstone masking: the
engine's ``wave_s`` less its ``rerank_s``."""


def read(rec):
    ops = rec.timed_ops("search")
    if not ops:
        return None
    return sum(op["timing"]["wave_s"] - op["timing"]["rerank_s"]
               for op in ops) / len(ops) * 1e3
