"""A cell whose configuration keeps its published widths in the CPU tests
(``_navisbench_widths.OWN``: fineweb768 at 768-d, M 96, r 48) runs end to
end through ``run.main``'s CPU route at those widths, cut in scale alone,
and is judged correct against the plain reference; its corpus repeats by
seed and has an exact top 10 that stands clear of rank 11."""
import json

import pytest
import torch

import _navisbench_tiny as tiny
import _navisbench_widths as widths
from navisbench import corpus, harness

CELLS = widths.cells()
SCENARIOS = [f"{c}:{t}" for c in CELLS for t in (0, 1)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return widths.make_root(tmp_path_factory.mktemp("widths"))


@pytest.fixture(scope="module")
def results(root):
    return tiny.drive(root, SCENARIOS)


def test_own_widths_are_the_published_ones(root):
    bench = harness.load_benchmark(root)
    for name, cut in widths.OWN.items():
        real = json.loads((tiny.REPO / "navisbench" / "configs" /
                           f"{name}.json").read_text())
        tiny_cfg = harness.load_config(root, bench, name)
        assert set(cut) <= {"n_base", "headroom", "build_block"}
        assert {k: v for k, v in tiny_cfg.items() if k not in cut} == \
            {k: v for k, v in real.items() if k not in cut}
    fw = harness.load_config(root, bench, "fineweb768")
    assert (fw["dim"], fw["r"], fw["pq_m"]) == (768, 48, 96)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cell_runs_at_its_own_widths(root, results, scenario):
    r = results[scenario]
    assert r["rc"] == 0, r["stderr"]
    res = r["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["device"]["platform"] == "cpu"
    cell, trace = scenario.split(":")
    kind = "per_layer" if trace == "1" else "end_to_end"
    bench = harness.load_benchmark(root)
    want = {m["name"] for m in harness.metrics_of(bench, cell, kind)
            if m["source"] != "device_trace"}
    assert set(res["metrics"]) == want
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"], name
    if trace == "1":
        rows = res["metrics"]["rerank_rows_per_query"]["value"]
        # CASR loads at least k rows of a pool of e_search
        assert 10 <= rows <= 40


def _corpus(name: str) -> tuple[dict, int]:
    cfg = json.loads((tiny.REPO / "navisbench" / "configs" /
                      f"{name}.json").read_text())
    return cfg["corpus"], cfg["dim"]


@pytest.mark.parametrize("seed", [0, 2**31 + 12_345])
def test_fineweb768_draws_repeat_by_seed(seed):
    block, dim = _corpus("fineweb768")

    def draws(s):
        g = corpus.generator(s, "cpu")
        return corpus.draw(g, corpus.mixture(g, block, dim), 64)

    a, b, other = draws(seed), draws(seed), draws(seed + 1)
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert a.shape == (64, 768) and a.dtype == torch.float32


def test_fineweb768_top10_stands_clear():
    """The 10th and 11th exact neighbours sit apart on the mixture, far
    more than on isotropic clusters of the same spread."""
    block, dim = _corpus("fineweb768")
    g = corpus.generator(11, "cpu")
    mix = corpus.mixture(g, block, dim)
    x, q = corpus.draw(g, mix, 4000), corpus.draw(g, mix, 200)

    def gaps(x, q, k=10):
        v = (torch.cdist(q.double(), x.double()) ** 2).topk(
            k + 1, largest=False).values
        return (v[:, k] - v[:, k - 1]) / v[:, k - 1]

    spread = (block["sigma_z"] ** 2 * block["d_int"] +
              block["sigma_eps"] ** 2 * dim) ** 0.5 / dim ** 0.5
    a = torch.randint(0, block["n_clusters"], (4200,), generator=g)
    iso = mix.centroids[a] + spread * torch.randn((4200, dim), generator=g)
    assert float(gaps(x, q).median()) > 3 * float(
        gaps(iso[:4000], iso[4000:]).median())
    assert float((gaps(x, q) < 1e-3).double().mean()) < 0.15
