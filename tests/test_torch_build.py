"""The port builds the conftest configuration on its own (N=1200, dim 48,
r 16, pq_m 24, build_block 64, build_e_pos 32, key PRNGKey(2)) from the
fixture's vectors, and the index holds up against the reference's."""
import numpy as np
import pytest
import torch

from conftest import _spec
from repro.core import recall_at_k as jrecall
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import Engine, check_invariants, recall_at_k
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port_build(dataset):
    eng = Engine(interop.spec_from(_spec("navis")), device="cpu")
    vecs = torch.from_numpy(np.array(dataset["vecs"]))
    state = eng.build(jr.PRNGKey(2), vecs, build_block=64, build_e_pos=32)
    return eng, state


def test_port_build_invariants(port_build):
    _, state = port_build
    inv = check_invariants(state.store)
    assert all(inv.values()), inv
    assert state.store.count == 1200


def test_port_build_pages_account_exactly(port_build):
    """Every edge page id is inside the budget, and page_live counts
    exactly the edgelists that point at each page."""
    store = port_build[1].store
    ep = store.edge_page.long()
    assert bool((ep >= 0).all()) and int(ep.max()) < store.p_max
    assert store.next_page <= store.p_max
    counts = torch.bincount(ep, minlength=store.p_max).to(torch.int32)
    assert torch.equal(counts, store.page_live)


def test_port_build_recall_near_reference(port_build, navis, dataset):
    """recall@10 >= 0.9, the reference's own bar at this configuration
    (tests/test_navis_core.py), and within 0.02 of the JAX build's recall
    on the same queries."""
    eng, state = port_build
    queries = np.array(dataset["queries"])
    truth = torch.from_numpy(np.array(dataset["truth"]))
    ids, _, _, _ = eng.search_many(state, torch.from_numpy(queries))
    recall = recall_at_k(ids, truth)
    jeng, jstate = navis
    jids, _, _, _ = jeng.search_many(jstate, dataset["queries"])
    ref_recall = float(jrecall(jids, dataset["truth"]))
    assert recall >= 0.9, recall
    assert abs(recall - ref_recall) <= 0.02, (recall, ref_recall)


def test_port_build_draws_match_reference(port_build, navis):
    """The threefry-driven choices are the reference's: the PQ training
    sample (hence codebooks to float32 rounding), the entrance members,
    the default entries and the cache's eviction key."""
    eng, state = port_build
    jeng, jstate = navis
    np.testing.assert_allclose(eng.codec.codebooks.numpy(),
                               np.asarray(jeng.codec.codebooks), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(state.ent.ids.numpy(),
                                  np.asarray(jstate.ent.ids))
    np.testing.assert_array_equal(state.default_entries.numpy(),
                                  np.asarray(jstate.default_entries))
    np.testing.assert_array_equal(state.cache.key.numpy(),
                                  np.asarray(jstate.cache.key).astype(
                                      np.int64))
