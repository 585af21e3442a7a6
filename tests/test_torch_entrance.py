"""The entrance search (``core/search.py``): on the card one
``entrance_search`` launch (``kernels/csrc/entrance_search.cu``), on the
CPU the host loop, its plain version.

The CPU tests hold a per-lane model of the kernel's algorithm (the seed
by the first live slot, the bitmap, the argmin over (distance, slot)
keys, the merge by counted ranks, ADC summed m = 0 .. M-1 in float32)
to the loop bit for bit on the corner cases, and check that CPU tensors
run the loop and count ``entry_iters`` and ``entry_lane_steps``.  The
tests marked ``card`` hold the kernel to the loop under
``plain_on_device()`` on the same cases, and on a wave of 10,000 lanes
at the deep96 cell's widths; they skip without a CUDA card."""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import search as search_mod
from repro_torch.core.entrance import EntranceGraph
from repro_torch.kernels import ops
from _torch_threads import one_torch_thread  # noqa: F401

INF = np.float32(3.4e38)

# name -> the entrance's shape and corner cases: M, ent_pool (P), r_ent
# (R); dead slots (ids -1) and an empty seed slot 0; lanes stopped by a
# small max_hops; a LUT of small integers (ties everywhere); no live slot;
# no iteration at all; one lane
CASES = {
    "m24_p32_r16": dict(m=24, p=32, r=16),
    "m32_p32_r32": dict(m=32, p=32, r=32),
    "m96_p64_r32": dict(m=96, p=64, r=32),
    "m32_p64_r16": dict(m=32, p=64, r=16),
    "dead_slots_empty_seed": dict(m=32, p=32, r=32, dead=0.3,
                                  seed_dead=True),
    "max_hops_5": dict(m=32, p=32, r=32, max_hops=5),
    "ties": dict(m=24, p=32, r=32, ties=True, dead=0.1),
    "no_live_slot": dict(m=32, p=32, r=16, dead=1.0),
    "max_hops_0": dict(m=32, p=32, r=32, max_hops=0),
    "one_lane": dict(m=32, p=32, r=32, b=1),
}


def _inputs(*, b, m, p, r, c=300, n=2000, dead=0.0, seed_dead=False,
            ties=False, max_hops=64, seed=0):
    """(entrance, lut [b, m, 256], codes [n, m], pool_size, max_hops): a
    random entrance of c slots, each linked to r distinct slots with a
    padded (-1) tail."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n, (c,), generator=g, dtype=torch.int32)
    kill = torch.rand(c, generator=g) < dead
    kill[0] |= seed_dead
    ids[kill] = -1
    edges = torch.stack([torch.randperm(c, generator=g)[:r]
                         for _ in range(c)]).to(torch.int32)
    deg = torch.randint(r // 2, r + 1, (c, 1), generator=g)
    edges[torch.arange(r)[None] >= deg] = -1
    if ties:
        lut = torch.randint(0, 4, (b, m, 256), generator=g).float()
    else:
        lut = torch.rand((b, m, 256), generator=g)
    codes = torch.randint(0, 256, (n, m), generator=g, dtype=torch.uint8)
    ent = EntranceGraph(ids=ids, edges=edges, count=int((ids >= 0).sum()),
                        main_to_ent=torch.full((n,), -1, dtype=torch.int32))
    return ent, lut, codes, p, max_hops


def _on(device, ent, lut, codes, p, max_hops):
    ent = EntranceGraph(ids=ent.ids.to(device), edges=ent.edges.to(device),
                        count=ent.count,
                        main_to_ent=ent.main_to_ent.to(device))
    return ent, lut.to(device), codes.to(device), p, max_hops


def _case(name, b=6, device="cpu"):
    kw = dict(CASES[name])
    kw.setdefault("b", b)
    return _on(device, *_inputs(**kw))


def _adc(lut_b, rows):
    """lut_b [M, 256]; rows [n, M] -> [n], summed m = 0 .. M-1 from 0."""
    acc = np.zeros(rows.shape[0], np.float32)
    for m in range(rows.shape[1]):
        acc = acc + lut_b[m, rows[:, m]]
    return acc


def _kernel_model(ent, lut, codes, p, max_hops):
    """The kernel's algorithm, lane by lane, in numpy."""
    ids, edges = ent.ids.numpy(), ent.edges.numpy()
    lut, codes = lut.numpy(), codes.numpy()
    c, r = edges.shape
    live = np.flatnonzero(ids >= 0)
    seed = int(live[0]) if live.size else 0
    outs = []
    for lb in lut:
        seen = np.zeros(c, bool)

        def has(s):
            return (s >= 0) & (s < c) & seen[np.clip(s, 0, c - 1)]

        pd = np.full(p, INF, np.float32)
        pi = np.full(p, -1, np.int32)
        pi[0] = seed
        if ids[seed] >= 0:
            pd[0] = _adc(lb, codes[ids[seed]][None])[0]
        unexp = (pi >= 0) & ~has(pi)
        hops = 0
        active = max_hops > 0 and unexp.any()
        while active:
            cand = np.where(unexp, pd, INF)
            j = min(range(p), key=lambda j: (float(cand[j]), j))
            v = int(pi[j])
            if 0 <= v < c:
                seen[v] = True
            nb = edges[max(v, 0)]
            valid = (nb >= 0) & ~has(nb) & ~np.isin(nb, pi)
            mid = np.where((nb >= 0) & (nb < c), ids[np.clip(nb, 0, c - 1)],
                           -1)
            nd = np.full(r, INF, np.float32)
            scored = valid & (mid >= 0)
            nd[scored] = _adc(lb, codes[mid[scored]])
            ni = np.where(valid, nb, -1).astype(np.int32)
            out_d = np.full(p, np.nan, np.float32)
            out_i = np.full(p, -2, np.int32)
            for j in range(p):
                rank = j + int((nd < pd[j]).sum())
                if rank < p:
                    out_d[rank], out_i[rank] = pd[j], pi[j]
            for q in range(r):
                before = (nd < nd[q]) | ((nd == nd[q]) & (np.arange(r) < q))
                rank = int((pd <= nd[q]).sum()) + int(before.sum())
                if rank < p:
                    out_d[rank], out_i[rank] = nd[q], ni[q]
            assert (out_i != -2).all()      # the ranks fill the pool
            pd, pi = out_d, out_i
            unexp = (pi >= 0) & ~has(pi)
            hops += 1
            active = hops < max_hops and unexp.any()
        main = np.where(pi >= 0, ids[np.clip(pi, 0, c - 1)], -1)
        outs.append((main, pd, hops))
    return (np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]),
            np.array([o[2] for o in outs], np.int32))


def _lanes(ent, lut, codes, p, max_hops, visited):
    return search_mod.entrance_lanes(ent, lut, codes, pool_size=p,
                                     max_hops=max_hops, visited=visited)


def _assert_same(got, want):
    (gm, gd, gh), (wm, wd, wh) = got, want
    assert torch.equal(gm.cpu(), wm.cpu())
    assert torch.equal(gd.cpu().view(torch.int32), wd.cpu().view(torch.int32))
    assert torch.equal(gh.cpu(), wh.cpu())


@pytest.mark.parametrize("visited", ["hash", "bitmap"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_the_loop(case, visited):
    """The kernel's algorithm gives the loop's E_ent, distances (bit for
    bit) and lane iterations."""
    ent, lut, codes, p, max_hops = _case(case)
    want = _lanes(ent, lut, codes, p, max_hops, visited)
    got = tuple(torch.from_numpy(a) for a in
                _kernel_model(ent, lut, codes, p, max_hops))
    _assert_same(got, want)
    if case == "max_hops_5":
        assert int(want[2].max()) == 5
    if case == "max_hops_0":
        assert int(want[2].max()) == 0


def test_cpu_runs_the_loop_and_counts():
    """CPU tensors run the host loop: no kernel launch, ``entry_iters``
    counted an iteration (the loop's reads one more), ``entry_lane_steps``
    the lanes' iterations summed, read at the next sync; the search's
    return values are the lanes' prefixes."""
    ent, lut, codes, p, max_hops = _case("dead_slots_empty_seed")
    before = dict(ops.launches)
    spans.take()
    with spans.span("entry"):
        main, d, hops = _lanes(ent, lut, codes, p, max_hops, "hash")
        entries, e_ent, e_d = search_mod.entrance_search(
            ent, lut, codes, n_entry=4, pool_size=p, max_hops=max_hops)
        spans.sync(lut)
    rec = spans.take()
    assert dict(ops.launches)["entrance_search"] == before["entrance_search"]
    iters = int(hops.max())
    assert iters > 0
    assert rec["counts"]["entry_iters"] == 2 * iters
    assert rec["counts"]["entry_lane_steps"] == 2 * int(hops.sum())
    assert rec["reads"]["entry/loop"][0] == 2 * (iters + 1)
    assert rec["reads"]["entry/seed"][0] == 4
    assert rec["reads"]["entry/counts"][0] == 1
    assert torch.equal(e_ent, main) and torch.equal(e_d, d)
    assert torch.equal(entries, main[:, :4])


def test_pending_counts_read_at_take():
    """Counts still pending when the record is taken are read then, and
    pending values under the same names add up on the device."""
    spans.take()
    spans.count_later(("a", "b"), torch.tensor([2, 3]))
    spans.count_later(("a", "b"), torch.tensor([4, 5]))
    spans.count_later(("c",), torch.tensor(7))
    rec = spans.take()
    assert rec["counts"] == {"a": 6, "b": 8, "c": 7}
    assert rec["reads"]["/counts"][0] == 2     # one a set of names


def test_kernel_wrapper_takes_cuda_tensors_only():
    ent, lut, codes, p, max_hops = _case("one_lane")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.entrance_search(lut, codes, ent.ids, ent.edges, pool_size=p,
                            max_hops=max_hops)
    assert ops.runs_plain(lut, codes, ent.ids, ent.edges)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_against_loop(ent, lut, codes, p, max_hops, visited):
    """The kernel's lanes and the loop's under plain_on_device(), with the
    launches and the record of the kernel's call."""
    before = dict(ops.launches)
    spans.take()
    with spans.span("entry"):
        got = _lanes(ent, lut, codes, p, max_hops, visited)
    launched = {k: ops.launches[k] - before[k] for k in before}
    rec = spans.take()
    with ops.plain_on_device():
        want = _lanes(ent, lut, codes, p, max_hops, visited)
    torch.cuda.synchronize()
    return got, want, launched, rec


@pytest.mark.card
@pytest.mark.parametrize("visited", ["hash", "bitmap"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_the_loop(cuda, case, visited):
    """One launch, no ADC or merge launch and no host read in the entrance;
    E_ent, the distances' bits and every lane's iterations equal the
    loop's; the two counters read after it."""
    got, want, launched, rec = _kernel_against_loop(
        *_case(case, b=256, device=cuda), visited)
    _assert_same(got, want)
    assert launched["entrance_search"] == 1
    assert launched["adc_distance"] == 0 and launched["pool_merge"] == 0
    assert "entry" not in {k.split("/")[0] for k in rec["reads"]}
    hops = want[2]
    assert rec["counts"] == {"entry_iters": int(hops.max()),
                             "entry_lane_steps": int(hops.sum())}


@pytest.mark.card
def test_kernel_wave_at_deep96_widths(cuda):
    """A wave of 10,000 lanes at the deep96 cell's widths: M 32, ent_pool
    32, r_ent 32, c_max 2,400 over 20,000 codes."""
    got, want, launched, rec = _kernel_against_loop(
        *_on(cuda, *_inputs(b=10_000, m=32, p=32, r=32, c=2400, n=20_000,
                            dead=0.05, seed=3)), "hash")
    _assert_same(got, want)
    assert launched["entrance_search"] == 1
    assert rec["counts"]["entry_iters"] == int(want[2].max())
