"""Mean ms of a search wave's replay of its traces into the cache (the
engine's ``replay_s``)."""


def read(rec):
    ops = rec.timed_ops("search")
    if not ops:
        return None
    return sum(op["timing"]["replay_s"] for op in ops) / len(ops) * 1e3
