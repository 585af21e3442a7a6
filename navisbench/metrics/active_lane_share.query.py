"""The share of the lanes the disk traversal's loop steps that made a
hop, in %: the window's traversal hops (``ctr_search.hops``, as
``hops_per_query.query`` reads it) over the lanes each loop iteration
ran on (the engine's ``traverse_lanes``), summed over every wave.  Below
100%, lanes that converged ride the loop until the wave's last one does;
a loop that drops them reads higher."""


def read(rec):
    ops = rec.ops_of("search")
    counts = [op["timing"].get("counts") for op in ops]
    if not ops or not all(c and "traverse_lanes" in c for c in counts):
        return None
    lanes = sum(c["traverse_lanes"] for c in counts)
    return 100.0 * rec.counters["search"]["hops"] / lanes if lanes else None
