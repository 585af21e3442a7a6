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


def _residency_premise(st) -> None:
    """What the cache kernels' map of resident pages rests on (its
    prologue traps where it fails): every page in window slot i has status
    IN_WINDOW and slot_of i, every page in frozen slot j IN_FROZEN and j,
    no page sits in two slots; and no other page has a status but
    NOT_CACHED."""
    g = interop.to_numpy(st)
    status, slot_of = np.asarray(g["status"]), np.asarray(g["slot_of"])
    listed = []
    for region, want in (("window_pages", tcache.IN_WINDOW),
                         ("frozen_pages", tcache.IN_FROZEN)):
        pages = np.asarray(g[region])
        slots = np.flatnonzero(pages >= 0)
        np.testing.assert_array_equal(status[pages[slots]], want,
                                      err_msg=region)
        np.testing.assert_array_equal(slot_of[pages[slots]], slots,
                                      err_msg=region)
        listed.extend(pages[slots].tolist())
    assert len(set(listed)) == len(listed)
    assert int((status != tcache.NOT_CACHED).sum()) == len(listed)


@pytest.mark.parametrize("cap", [30, 256])
@pytest.mark.parametrize("policy", POLICIES)
def test_residency_premise_holds_on_every_state(policy, cap):
    """The premise holds after every operation chunk of a stream of
    accesses, hints and admits (the port's handle), after
    ``invalidate_where`` and ``grow`` on the result, and on the
    reference's state after the same stream, imported through
    ``interop``."""
    p_max = 4 * cap
    kinds, pages = _stream(3 * cap + len(policy), cap, 12 * cap)
    st = tcache.init_cache(p_max, cap, policy, jr.PRNGKey(13),
                           device="cpu")
    _residency_premise(st)
    step = 3 * cap
    for lo in range(0, pages.shape[0], step):
        cache = tcache.open(st)
        cache.apply(torch.from_numpy(pages[lo:lo + step]),
                    torch.from_numpy(kinds[lo:lo + step]))
        st = cache.state()
        _residency_premise(st)
    drop = torch.from_numpy(np.random.default_rng(cap).random(p_max) < 0.3)
    _residency_premise(tcache.invalidate_where(st, drop))
    grown = tcache.grow(st, p_max + 17)
    _residency_premise(grown)
    cache = tcache.open(grown)
    cache.access(torch.tensor([p_max + 16, p_max, 3]))
    _residency_premise(cache.state())
    st_j = jcache.init_cache(p_max, cap, policy, jax.random.PRNGKey(13))
    _, st_j = _ref_stream(st_j, jnp.asarray(kinds), jnp.asarray(pages))
    _residency_premise(interop.cache_from(st_j, device="cpu"))


@pytest.mark.parametrize("entry", ["apply_traces", "priority_admit",
                                   "invalidate_pages"])
def test_card_handle_copies_once_and_leaves_the_caller(entry, monkeypatch):
    """Through the card's handle class (driven here over CPU tensors on
    the plain route) each state entry leaves the caller's state as it was
    and equals the host replay; the handle copies the tables once, when it
    opens, and hands them to the state it returns."""
    cap = 30
    kinds, pages = _stream(17, cap, 200)
    st = tcache.init_cache(4 * cap, cap, "navis", jr.PRNGKey(5),
                           device="cpu")
    host = tcache.open(st)
    host.apply(torch.from_numpy(pages), torch.from_numpy(kinds))
    st = host.state()
    before = interop.to_numpy(st)
    traces = torch.from_numpy(np.where(np.arange(40) < 30, pages[:40], -1)
                              .astype(np.int32)[None].repeat(2, 0))
    targets = [int(p) for p in np.asarray(before["frozen_pages"])
               if p >= 0][:3] + [int(pages[3]), -1]
    run = {"apply_traces": lambda: tcache.apply_traces(st, traces),
           "priority_admit": lambda: tcache.priority_admit(st, 7),
           "invalidate_pages": lambda: tcache.invalidate_pages(st,
                                                               targets)}
    want = run[entry]()
    monkeypatch.setattr(tcache, "open", tcache.DeviceCache)
    got = run[entry]()
    if entry == "apply_traces":
        assert int(got[0]) == int(want[0])
        got, want = got[1], want[1]
    _same_cache(got, want)
    after = interop.to_numpy(st)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name],
                                      err_msg=name)
    handle = tcache.DeviceCache(st)
    tables = handle.tables
    assert all(t.data_ptr() != getattr(st, n).data_ptr()
               for t, n in zip(tables, tcache.TABLES))
    handle.replay(traces)
    out = handle.state()
    assert all(getattr(out, n) is t for t, n in zip(tables, tcache.TABLES))
    with pytest.raises(RuntimeError):
        handle.state()


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
