"""One rank of the port's sharded search and insert over a gloo group,
for ``test_torch_distributed.py``: it imports only torch and the port.

The parent saves the job with ``torch.save``: the engine's spec and
codebooks, this rank's shard states, the queries, the routed inserts
and their mask.  Each rank writes ``(ids, dists, states after the
search, states after the insert)`` next to it.
"""
import torch
import torch.distributed as dist

from repro_torch.core import distributed as tdist
from repro_torch.core.engine import Engine
from repro_torch.core.pq import PQCodec


def run(rank: int, world: int, store: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        w = torch.load(job, weights_only=False)
        eng = Engine(w["spec"], device="cpu")
        eng.set_codec(PQCodec(w["codebooks"]))
        group = dist.group.WORLD
        mine = tdist.owned_shards(len(w["states"]), group)
        states = [w["states"][s] for s in mine]
        search = tdist.make_sharded_search(eng, w["n_per"], group=group)
        ids, dists, searched = search(states, w["queries"])
        insert = tdist.make_sharded_insert(eng, w["bucket"], group=group)
        inserted = insert(searched, w["routed"], w["valid"])
        torch.save((ids, dists, searched, inserted), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()
