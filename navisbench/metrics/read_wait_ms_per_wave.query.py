"""Mean ms a search wave's host spent blocked in the entrance search's and
the disk traversal's reads of device values (the engine's ``entry/*`` and
``traverse/*`` reads: loop conditions, the entrance seed, the visited
sets' probe checks).  The timing syncs of the later stages, the cache
replay's among them, are left out, so ``entry_ms + disk_ms`` less this is
the traversal's host issue."""


def read(rec):
    ops = rec.timed_ops("search")
    reads = [op["timing"].get("reads") for op in ops]
    if not ops or not all(reads):
        return None
    return sum(s for r in reads for k, (_, s) in r.items()
               if k.startswith(("entry/", "traverse/"))) / len(ops) * 1e3
