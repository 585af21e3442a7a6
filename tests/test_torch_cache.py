"""The port's cache state machine against the reference: op streams of
accesses, eviction hints and entrance admits (``-1`` holes skipped) for
every policy, through ``cache.open`` on the CPU and through the
reference's ``access`` / ``invalidate_page`` / ``priority_admit`` under
one jitted ``lax.scan``; the cache kernels' plain route (``ops.cache_ops``
/ ``ops.cache_replay`` on CPU tensors, ``ref.cache_apply``) and the card's
handle class run on it, alone and under the engine's paths; the
reference's ``frozen_fill`` count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import cache as tcache
from repro_torch.kernels import ops
from test_torch_engine import _same, _same_tree
from test_torch_insert import _t, _wave
from _torch_threads import one_torch_thread  # noqa: F401

POLICIES = ["navis", "lru", "clock", "lfu", "none"]


def _same_cache(got, want):
    """Every CacheState field equal, the key included."""
    g, w = interop.to_numpy(got), interop.to_numpy(want)
    assert set(g) == set(w)
    for name in w:
        np.testing.assert_array_equal(
            np.asarray(g[name]).astype(np.int64),
            np.asarray(w[name]).astype(np.int64), err_msg=name)


def _stream(seed: int, cap: int, n: int):
    """(kinds [n] int8, pages [n] int32): mostly accesses over a skewed
    range of 3 x cap pages (hot pages re-hit, so the NAVIS window
    promotes and CLOCK sweeps), a tenth eviction hints, a tenth admits,
    and -1 holes."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice([ops.ACCESS, ops.INVALIDATE, ops.PRIORITY_ADMIT], n,
                       p=[0.8, 0.1, 0.1]).astype(np.int8)
    pages = np.floor(3 * cap * rng.random(n) ** 3).astype(np.int32)
    pages[rng.random(n) < 0.05] = -1
    return kinds, pages


@jax.jit
def _ref_stream(st, kinds, pages):
    """The reference's operations in order, -1 pages skipped."""
    def step(carry, op):
        st, hits = carry
        kind, page = op

        def access(s):
            hit, s = jcache.access(s, page)
            return s, hit.astype(jnp.int32)

        def invalidate(s):
            return jcache.invalidate_page(s, page), jnp.int32(0)

        def admit(s):
            return jcache.priority_admit(s, page), jnp.int32(0)

        st, h = jax.lax.cond(
            page >= 0,
            lambda s: jax.lax.switch(kind, [access, invalidate, admit], s),
            lambda s: (s, jnp.int32(0)), st)
        return (st, hits + h), None

    (st, hits), _ = jax.lax.scan(step, (st, jnp.int32(0)),
                                 (kinds.astype(jnp.int32), pages))
    return hits, st


@pytest.mark.parametrize("cap", [30, 256])
@pytest.mark.parametrize("policy", POLICIES)
def test_op_stream_matches_reference(policy, cap):
    """Accesses, invalidations and admits, interleaved with -1 holes, give
    every CacheState field and the hit count of the reference."""
    p_max = 4 * cap
    kinds, pages = _stream(cap + len(policy), cap, 12 * cap)
    st_j = jcache.init_cache(p_max, cap, policy, jax.random.PRNGKey(11))
    hits_j, st_j = _ref_stream(st_j, jnp.asarray(kinds), jnp.asarray(pages))
    st_t = tcache.init_cache(p_max, cap, policy, jr.PRNGKey(11),
                             device="cpu")
    cache = tcache.open(st_t)
    hits_t = cache.apply(torch.from_numpy(pages), torch.from_numpy(kinds))
    assert int(hits_t) == int(hits_j)
    _same_cache(cache.state(), st_j)
    if policy == "navis":
        assert int(st_j.frozen_fill) > 0      # threefry probes were drawn
    if policy == "none":
        assert int(st_j.clock) == int(((kinds == ops.ACCESS) &
                                       (pages >= 0)).sum())


@pytest.mark.parametrize("policy", POLICIES)
def test_handle_calls_match_one_stream(policy):
    """``access``, ``invalidate`` and ``priority_admit`` on a handle, one
    call an operation (pages as tensors, a list, an int), equal one
    ``apply`` of the same stream."""
    cap = 30
    kinds, pages = _stream(5, cap, 300)
    st = tcache.init_cache(4 * cap, cap, policy, jr.PRNGKey(2), device="cpu")
    one = tcache.open(st)
    want_hits = one.apply(torch.from_numpy(pages), torch.from_numpy(kinds))
    calls = tcache.open(st)
    got_hits = 0
    for kind, page in zip(kinds.tolist(), pages.tolist()):
        if kind == ops.ACCESS:
            got_hits += int(calls.access(torch.tensor([[page]])))
        elif kind == ops.INVALIDATE:
            calls.invalidate([page])
        else:
            calls.priority_admit(page)
    assert got_hits == int(want_hits)
    _same_cache(calls.state(), one.state())


@pytest.mark.parametrize("policy", POLICIES)
def test_open_gives_host_handle_and_replay_equals_apply_traces(policy):
    """A CPU state opens as the host state machine; its replay gives
    ``apply_traces``' hits and state, and the state it was opened on is
    left as it was."""
    rng = np.random.default_rng(9)
    traces = np.full((5, 60), -1, np.int32)
    for q in range(5):
        n = rng.integers(10, 60)
        traces[q, :n] = rng.integers(0, 90, n)
    st = tcache.init_cache(200, 30, policy, jr.PRNGKey(4), device="cpu")
    before = interop.to_numpy(st)
    cache = tcache.open(st)
    assert isinstance(cache, tcache.HostCache)
    hits = cache.replay(torch.from_numpy(traces))
    want_hits, want = tcache.apply_traces(st, torch.from_numpy(traces))
    assert hits.dtype == torch.int32 and hits.shape == (1,)
    assert int(hits) == int(want_hits)
    _same_cache(cache.state(), want)
    after = interop.to_numpy(st)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])


@pytest.mark.parametrize("policy", POLICIES)
def test_kernel_entries_plain_route_match_handle(policy):
    """``ops.cache_replay`` / ``ops.cache_ops`` on CPU tensors (the plain
    version, ``ref.cache_apply``) update the tables in place exactly as
    the host handle does, and launch nothing; so does the card's handle
    class driven over CPU tensors."""
    ops.reset_launches()
    cap = 30
    kinds, pages = _stream(8, cap, 400)
    traces = np.where(np.arange(50) < 40, pages[:50], -1)[None].astype(
        np.int32).repeat(3, 0)
    st = tcache.init_cache(4 * cap, cap, policy, jr.PRNGKey(6), device="cpu")
    host = tcache.open(st)
    want_r = host.replay(torch.from_numpy(traces))
    want_o = host.apply(torch.from_numpy(pages), torch.from_numpy(kinds))
    tables = [getattr(st, n).clone() for n in tcache.TABLES]
    got_r = ops.cache_replay(st.policy, tables, torch.from_numpy(traces))
    got_o = ops.cache_ops(st.policy, tables, torch.from_numpy(pages),
                          torch.from_numpy(kinds))
    assert int(got_r) == int(want_r) and int(got_o) == int(want_o)
    _same_cache(tcache.CacheState(st.policy, **dict(zip(tcache.TABLES,
                                                        tables))),
                host.state())
    dev = tcache.DeviceCache(st)
    assert int(dev.replay(torch.from_numpy(traces))) == int(want_r)
    assert int(dev.apply(torch.from_numpy(pages),
                         torch.from_numpy(kinds))) == int(want_o)
    _same_cache(dev.state(), host.state())
    assert all(v == 0 for v in ops.launches.values())


def test_scalars_are_device_tensors():
    """``init_cache``'s and ``cache_from``'s frozen_fill, clock_hand and
    clock are 0-d int32 tensors on the given device."""
    st = tcache.init_cache(50, 10, "navis", jr.PRNGKey(0), device="cpu")
    st_j = jcache.init_cache(50, 10, "navis", jax.random.PRNGKey(0))
    _, st_j = jcache.apply_traces(st_j, jnp.arange(40, dtype=jnp.int32)[None])
    for got in (st, interop.cache_from(st_j, device="cpu"),
                tcache.apply_traces(st, torch.arange(40)[None])[1]):
        for name in ("frozen_fill", "clock_hand", "clock"):
            t = getattr(got, name)
            assert isinstance(t, torch.Tensor) and t.dim() == 0
            assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert int(interop.cache_from(st_j, device="cpu").clock) == 40


def test_page_past_the_tables_raises():
    st = tcache.init_cache(20, 10, "navis", jr.PRNGKey(0), device="cpu")
    with pytest.raises(IndexError):
        tcache.open(st).access(torch.tensor([3, 20]))
    with pytest.raises(IndexError):
        ops.cache_replay(st.policy, [getattr(st, n).clone()
                                     for n in tcache.TABLES],
                         torch.tensor([[1, 25]], dtype=torch.int32))


def test_reference_frozen_fill_counts_refilled_slots_twice():
    """The reference counts installs into empty frozen slots and never
    lowers the count on an invalidation, so after a full frozen region, an
    invalidated frozen page and another admit, ``frozen_fill`` exceeds the
    slots occupied.  The port keeps the count."""
    cap = 10                                      # W 1, F 9
    st_t = tcache.init_cache(100, cap, "navis", jr.PRNGKey(3), device="cpu")
    cache = tcache.open(st_t)
    n_admit = 0
    while int(cache.state().frozen_fill) < 9:
        cache.priority_admit(n_admit)
        n_admit += 1
        assert n_admit < 200
    victim = int(cache.state().frozen_pages[0])
    cache.invalidate(victim)
    cache.priority_admit(99)
    got = cache.state()

    admit = jax.jit(jcache.priority_admit)
    st_j = jcache.init_cache(100, cap, "navis", jax.random.PRNGKey(3))
    for page in range(n_admit):
        st_j = admit(st_j, jnp.int32(page))
    assert int(st_j.frozen_fill) == 9
    st_j = jcache.invalidate_page(st_j, jnp.int32(victim))
    st_j = admit(st_j, jnp.int32(99))
    _same_cache(got, st_j)
    occupied = int((np.asarray(st_j.frozen_pages) >= 0).sum())
    assert int(got.frozen_fill) == int(st_j.frozen_fill) > occupied


@pytest.mark.parametrize("path", ["search_many", "search_batch",
                                  "insert_many", "insert_batch"])
def test_engine_paths_through_card_handle(path, navis, dataset, monkeypatch):
    """The card's handle class, ``DeviceCache``, run here over CPU tensors
    through the kernels' plain route, gives each engine path (a wave's
    replay and its commits' stream; a threaded traversal a hop at a time,
    its hints and admits) exactly the host handle's results and state."""
    eng, state = navis
    teng = interop.engine_from(eng, device="cpu")
    tstate = interop.engine_state_from(state, device="cpu")
    x = (_t(np.array(dataset["queries"][:8])) if path.startswith("search")
         else _t(_wave(dataset, 8, seed=21)))
    want = getattr(teng, path)(tstate, x)
    ops.reset_launches()
    monkeypatch.setattr(tcache, "open", tcache.DeviceCache)
    got = getattr(teng, path)(tstate, x)
    assert all(v == 0 for v in ops.launches.values())
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            _same(g, w, path)
        else:
            _same_tree(g, w, path)
    assert int(got[-1].cache.clock) > int(tstate.cache.clock)
