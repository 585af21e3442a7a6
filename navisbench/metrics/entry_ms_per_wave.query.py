"""Mean ms of a search wave's entrance search (the engine's ``entry``
span: the in-memory beam search over the entrance graph, or the default
entries)."""


def read(rec):
    ops = rec.timed_ops("search")
    spans = [op["timing"].get("spans") for op in ops]
    if not ops or not all(spans):
        return None
    return sum(s.t1 - s.t0 for sp in spans for s in sp
               if s.name == "entry") / len(ops) * 1e3
