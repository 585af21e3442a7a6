"""Mean ms of a search wave's CASR rerank (the engine's ``rerank_s``)."""


def read(rec):
    ops = rec.timed_ops("search")
    if not ops:
        return None
    return sum(op["timing"]["rerank_s"] for op in ops) / len(ops) * 1e3
