"""Mean count of a search wave's host reads of device values, every site
and stage (the engine's ``reads``: loop conditions, the entrance seed,
the visited sets' probe checks, and the timing syncs), each one a wait
for the device."""


def read(rec):
    ops = rec.timed_ops("search")
    reads = [op["timing"].get("reads") for op in ops]
    if not ops or not all(reads):
        return None
    return sum(n for r in reads for n, _ in r.values()) / len(ops)
