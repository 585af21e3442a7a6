"""Mean ms of a search wave's on-disk traversal (the engine's
``traverse`` span: ``search.disk_traverse``)."""


def read(rec):
    ops = rec.timed_ops("search")
    spans = [op["timing"].get("spans") for op in ops]
    if not ops or not all(spans):
        return None
    return sum(s.t1 - s.t0 for sp in spans for s in sp
               if s.name == "traverse") / len(ops) * 1e3
