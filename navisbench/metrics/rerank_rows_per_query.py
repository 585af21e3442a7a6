"""Vector rows CASR loaded a query: the engine's ``rerank_rows`` (the sum
of ``casr_rerank``'s ``n_loaded`` over a wave's lanes) over the queries
of the window's waves.  Nothing on a record without the count."""


def read(rec):
    ops = rec.ops_of("search")
    counts = [op["timing"].get("counts", {}) for op in ops]
    if not ops or not all("rerank_rows" in c for c in counts):
        return None
    return sum(c["rerank_rows"] for c in counts) / sum(op["n"] for op in ops)
