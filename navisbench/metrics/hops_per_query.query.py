"""Traversal hops a query (``ctr_search.hops`` over every wave)."""


def read(rec):
    n = sum(op["n"] for op in rec.ops_of("search"))
    return rec.counters["search"]["hops"] / n if n else None
