"""The plain references (exact neighbours, the page cache's replay) and
the comparison that decides ``correct``."""
import numpy as np
import pytest
import torch

from navisbench import compare
from navisbench.cache_watch import on_host
from navisbench.cell import Outputs
from navisbench.reference import cache as ref_cache
from navisbench.reference import exact


def _data(seed=0, n=500, q=40, d=24):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)))


def _brute(queries, corpus, k):
    x = corpus.numpy().astype(np.float64)
    ids, dists = [], []
    for q in queries.numpy().astype(np.float64):
        d = ((x - q) ** 2).sum(1)
        order = np.argsort(d, kind="stable")[:k]
        ids.append(order)
        dists.append(d[order])
    return np.array(ids), np.array(dists)


@pytest.mark.parametrize("k", [1, 10])
def test_topk_equals_brute_force(k):
    corpus, queries = _data()
    ids, dists = exact.topk(queries, corpus, k)
    want_ids, want_d = _brute(queries, corpus, k)
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(dists.numpy(), want_d, rtol=1e-9, atol=1e-9)


def test_pair_dist():
    corpus, queries = _data()
    ids = torch.randint(0, corpus.shape[0], (queries.shape[0], 10))
    ids[0, 0] = -1
    ids[1, 1] = corpus.shape[0]
    got = exact.pair_dist(queries, corpus, ids).numpy()
    x, q = corpus.numpy().astype(np.float64), queries.numpy().astype(
        np.float64)
    want = ((q[:, None, :] - x[ids.clamp(0, corpus.shape[0] - 1)]) ** 2).sum(-1)
    assert np.isnan(got[0, 0]) and np.isnan(got[1, 1])
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12)


def _cache_wave(seed=0, p_max=400, capacity=40, q=30, t=12, span=120):
    """A cache state warmed by one replay and a wave's traces after it,
    as the port's host replay runs them: (before, traces, after)."""
    from repro_torch import random as jr
    from repro_torch.core import cache as port_cache
    g = torch.Generator().manual_seed(seed)
    st = port_cache.init_cache(p_max, capacity, "navis", jr.PRNGKey(seed),
                               device="cpu")

    def traces():
        tr = torch.randint(0, span, (q, t), generator=g, dtype=torch.int32)
        n = torch.randint(0, t + 1, (q,), generator=g)
        return torch.where(torch.arange(t)[None] < n[:, None], tr, -1)

    _, before = port_cache.apply_traces(st, traces())
    tr = traces()
    _, after = port_cache.apply_traces(before, tr)
    return before, tr, after


def _outputs(n=500, q=64, k=10, cache_seed=0):
    corpus, pool = _data(n=n, q=q)
    ids, dists = exact.topk(pool, corpus, k)
    before, tr, after = _cache_wave(cache_seed)
    hits = int(port_hits(before, tr))
    watched = {"policy": "navis", "breaks": 0, "waves": 1,
               "sampled": [{"wave": 0, "before": on_host(before),
                            "traces": tr.numpy(), "after": on_host(after),
                            "hits": hits}]}
    return Outputs(pool=pool, query_rows=torch.arange(q), ids=ids,
                   dists=dists.to(torch.float32),
                   recall_rows=torch.arange(0, q, 2), base=corpus,
                   cache=watched)


def port_hits(before, tr):
    """The hits the port's traversal counts against the snapshot: its
    lookup over the charged pages."""
    from repro_torch.core import cache as port_cache
    charged = tr >= 0
    return (port_cache.lookup(before, tr.clamp(min=0)) & charged).sum()


LIMITS = {"bad_answers": 0, "dist_err": 1e-5, "missed_at_10": 0.3,
          "cache_replay_diff": 0, "cache_chain_breaks": 0}


def test_exact_answers_pass():
    numbers, correct, recall = compare.judge(_outputs(), LIMITS, 10)
    assert correct and recall == 1.0
    assert numbers["bad_answers"]["value"] == 0
    assert numbers["missed_at_10"]["value"] == 0
    assert numbers["cache_replay_diff"]["value"] == 0
    assert numbers["dist_err"]["value"] < 1e-6


@pytest.mark.parametrize("fault", ["out_of_range", "repeated", "not_finite",
                                   "out_of_order"])
def test_bad_answers_counted(fault):
    out = _outputs()
    ids, d = out.ids.clone(), out.dists.clone()
    if fault == "out_of_range":
        ids[3, 4] = -1
    elif fault == "repeated":
        ids[3, 4] = ids[3, 5]
        d[3, 4] = d[3, 5]
    elif fault == "not_finite":
        d[3, 9] = float("inf")
    else:
        d[3, 0], d[3, 1] = d[3, 1].item(), d[3, 0].item()
        ids[3, 0], ids[3, 1] = ids[3, 1].item(), ids[3, 0].item()
    out.ids, out.dists = ids, d
    numbers, correct, _ = compare.judge(out, LIMITS, 10)
    assert numbers["bad_answers"]["value"] == 1 and not correct


def test_dist_err_is_relative():
    """Every returned distance 1e-4 above the exact one reads 1e-4."""
    out = _outputs()
    out.dists = out.dists * (1 + 1e-4)
    numbers, correct, _ = compare.judge(out, LIMITS, 10)
    assert not correct
    assert numbers["dist_err"]["value"] == pytest.approx(1e-4, rel=1e-2)


def test_missed_counts_other_lanes_answers():
    """Answers of other queries, with their exact distances, pass every
    other number and miss most of the top 10."""
    out = _outputs()
    out.ids = out.ids.roll(1, 0)
    q = out.pool[out.query_rows]
    out.dists = exact.pair_dist(q, out.base, out.ids).to(torch.float32)
    order = out.dists.argsort(1)
    out.ids, out.dists = out.ids.gather(1, order), out.dists.gather(1, order)
    numbers, correct, recall = compare.judge(out, LIMITS, 10)
    assert numbers["dist_err"]["value"] < 1e-6
    assert numbers["bad_answers"]["value"] == 0
    assert numbers["missed_at_10"]["value"] > 0.5 and not correct
    assert recall == pytest.approx(1 - numbers["missed_at_10"]["value"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cache_replay_equals_the_port(seed):
    """The reference's replay and hit count equal the port's host replay,
    promotions and threefry draws included."""
    before, tr, after = _cache_wave(seed, span=60 + 40 * seed)
    want = ref_cache.replay(on_host(before), tr.numpy())
    assert ref_cache.differences(on_host(after), want) == 0
    assert on_host(after)["frozen_fill"] > 0
    assert ref_cache.snapshot_hits(on_host(before), tr.numpy()) == \
        int(port_hits(before, tr))


@pytest.mark.parametrize("fault", ["skipped", "altered", "hits", "break"])
def test_cache_faults_counted(fault):
    out = _outputs()
    w = out.cache["sampled"][0]
    if fault == "skipped":
        w["after"] = w["before"]
    elif fault == "altered":
        w["after"] = dict(w["after"], clock=w["after"]["clock"] + 1)
    elif fault == "hits":
        w["hits"] += 1
    else:
        out.cache["breaks"] = 1
    numbers, correct, _ = compare.judge(out, LIMITS, 10)
    assert not correct
    name = "cache_chain_breaks" if fault == "break" else "cache_replay_diff"
    assert numbers[name]["value"] > 0


def test_every_number_needs_a_limit():
    with pytest.raises(KeyError):
        compare.judge(_outputs(), {"bad_answers": 0, "dist_err": 1e-5}, 10)
