"""Device-dispatched wrappers for the hand-written kernels (port of
``repro/kernels/ops.py``; ``casr_rerank`` fuses the CASR loop of
``repro/core/casr.py`` around the reference's rerank and merge kernels).

Entry points: ``adc_distance``, ``pool_merge`` (and
``pool_merge_chunked``, successive merges within the kernel's width;
``pool_merge_with_routes`` counts the kernel's route by lane),
``rerank_l2`` (rows the caller holds, ``[B, S, D]``), ``rerank_l2_rows``
(rows read in place by id, ``[B, S]`` ids into ``[N, D]``: the full
rerank), ``rerank_l2_shared`` (every lane against the same ``[S, D]``
rows: FreshDiskANN's buffer scan, on the tensor cores behind a guard that
recomputes near pairs with the row body),
``casr_rerank`` (its rows prefetched a group ahead through a ring in
shared memory; ``casr_rerank_stages`` says which route a call takes),
``entrance_search`` (every lane's whole entrance beam search, the ADC and
the merge fused; its plain version is the host loop in
:mod:`repro_torch.core.search`, which calls it where :func:`runs_plain`
says no), and the cache's serial state machine: ``cache_replay``
(trace rows in wave order) and ``cache_ops`` (a stream of accesses,
eviction hints and entrance admits), both in place on a ``CacheState``'s
tensors (``CACHE_TABLES``).

==============  ===================================================
tensor device   implementation
==============  ===================================================
cpu             the plain versions in :mod:`repro_torch.kernels.ref`
cuda            the hand-written CUDA kernels in ``csrc/`` (built by
                :mod:`repro_torch.kernels._build` at the first call)
==============  ===================================================

For a CUDA tensor a wrapper launches its kernel or raises: a build or
launch error surfaces, nothing falls back.  The one other route is
:func:`plain_on_device`, which ``chip_smoke.py``'s A/B phase uses to run
the plain versions on the card; no port module uses it.

Each wrapper adds one to ``launches[name]`` where it launches its kernel,
and nowhere else, so a run can show that the main path went through the
kernels.  Kernels launch on the current stream and allocate nothing; the
wrapper checks device, dtype, shape and contiguity and allocates the
outputs.  The library's entry points and PyTorch's raw-stream accessor are
resolved once, at the first CUDA call, so a launch costs the checks, the
output allocations and one ``ctypes`` call.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ref

launches = {"pool_merge": 0, "adc_distance": 0, "rerank_l2": 0,
            "rerank_l2_rows": 0, "rerank_l2_shared": 0, "casr_rerank": 0,
            "cache_replay": 0, "cache_ops": 0, "entrance_search": 0}
POOL_MERGE_MAX = 1024    # the merge kernel's width limit, P + Q
# the merge kernel's routes, by lane (csrc/pool_merge.cu): a sorted pool
# (every caller's) ranks the new entries below its largest by counting, or
# sends all P + Q keys through the sort network where they are too many;
# an unsorted one sorts all P + Q keys
POOL_MERGE_ROUTES = ("sorted_count", "sorted_network", "unsorted")
# rerank_l2_shared's guard (csrc/rerank_l2_shared.cu): the shifted expanded
# form with q'.x' in 3xTF32 is within SHARED_EPS (||q'||^2 + ||x'||^2) of
# the exact d; a pair with d^ <= SHARED_TAU (||q'||^2 + ||x'||^2) is
# recomputed in the difference form, so every other pair is within the
# rerank grade's rtol (RERANK_RTOL) and every pair with exact d <=
# (SHARED_TAU - 2 SHARED_EPS) (||q'||^2 + ||x'||^2) is recomputed
RERANK_RTOL, RERANK_ATOL = 1e-5, 1e-3
SHARED_EPS = 2.0 ** -20
SHARED_TAU = SHARED_EPS * (1 + 1 / RERANK_RTOL)
SHARED_MAX_D = 8192      # the shift vector lives in shared memory
# The CacheState tensors the cache kernels update in place, in the C
# entries' order, with their dtypes and ranks
CACHE_TABLES = (("status", torch.int8, 1), ("hits", torch.int32, 1),
                ("slot_of", torch.int32, 1), ("window_pages", torch.int32, 1),
                ("window_last", torch.int32, 1),
                ("frozen_pages", torch.int32, 1),
                ("frozen_last", torch.int32, 1),
                ("frozen_fill", torch.int32, 0),
                ("clock_hand", torch.int32, 0), ("clock", torch.int32, 0),
                ("key", torch.int64, 1))
ACCESS, INVALIDATE, PRIORITY_ADMIT = 0, 1, 2     # cache_ops' kinds
# The cache kernels hold the region tables, the window's hits and list,
# the map of resident pages and the drawn-ahead installs in shared memory
# (at most 227 KB), so W + F <= 8,225 slots whatever the split
# (csrc/cache_replay.cu, cache_smem_bytes)
CACHE_SMEM_MAX = 227 * 1024
# entrance_search's limits (csrc/entrance_search.cu): the pool and the
# degree, two entries a thread of the lane's warp; the LUT and the
# expanded bitmap share one block's shared memory
ENTRANCE_MAX_POOL = 64
ENTRANCE_MAX_DEG = 64
ENTRANCE_SMEM_MAX = 227 * 1024
_plain_on_device = False
_entry: dict = {}       # C entry point name -> ctypes function
_raw_stream = None      # device index -> its current stream's handle


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def plain_on_device():
    """Run the plain versions on CUDA tensors too (A/B comparisons only)."""
    global _plain_on_device
    prev, _plain_on_device = _plain_on_device, True
    try:
        yield
    finally:
        _plain_on_device = prev


def _use_plain(*tensors: torch.Tensor) -> bool:
    if all(t.is_cpu for t in tensors):
        return True
    if not all(t.is_cuda for t in tensors) or \
            len({t.get_device() for t in tensors}) != 1:
        raise ValueError(f"kernel inputs on unsupported or mixed devices: "
                         f"{[str(t.device) for t in tensors]}")
    return _plain_on_device


def runs_plain(*tensors: torch.Tensor) -> bool:
    """Whether the wrappers run the plain versions on ``tensors`` (CPU
    tensors, or CUDA ones under :func:`plain_on_device`); for a kernel
    whose plain version lives with its caller (``entrance_search``)."""
    return _use_plain(*tensors)


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _resolve() -> None:
    """Build and load the library (first CUDA call only) and keep its entry
    points and the raw-stream accessor."""
    global _raw_stream
    from repro_torch.kernels import _build
    lib = _build.library()
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _entry.update({name: getattr(lib, name) for name in _build.SIGNATURES})


def _call(fn_name: str, t: torch.Tensor, *args) -> None:
    """Launch on the current stream of ``t``'s device; raise on an error."""
    if not _entry:
        _resolve()
    err = _entry[fn_name](*args, _raw_stream(t.get_device()))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def adc_distance(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [B, M, 256] f32; codes [B, C, M] uint8 -> [B, C] PQ distances."""
    if _use_plain(lut, codes):
        return ref.adc_distance_ref(lut, codes)
    _check(lut, "lut", torch.float32, 3)
    _check(codes, "codes", torch.uint8, 3)
    b, m, k = lut.shape
    c = codes.shape[1]
    if k != 256 or codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"adc_distance shapes: lut {tuple(lut.shape)}, "
                         f"codes {tuple(codes.shape)}")
    if m * 256 * 4 > 227 * 1024 or lut.data_ptr() % 16 or b > 65535:
        raise ValueError("adc_distance: the LUT must fit shared memory "
                         "(M <= 227) and be 16-byte aligned, and B <= 65535 "
                         "(one grid row per lane)")
    out = lut.new_empty((b, c))
    if b and c:
        _call("adc_distance_launch", lut, lut.data_ptr(), codes.data_ptr(),
              out.data_ptr(), b, c, m)
        launches["adc_distance"] += 1
    return out


def rerank_l2(q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """q [B, D] f32; xs [B, S, D] f32 -> [B, S] exact squared L2."""
    if _use_plain(q, xs):
        return ref.rerank_l2_ref(q, xs)
    _check(q, "q", torch.float32, 2)
    _check(xs, "xs", torch.float32, 3)
    b, s, d = xs.shape
    if q.shape != (b, d):
        raise ValueError(f"rerank_l2 shapes: q {tuple(q.shape)}, "
                         f"xs {tuple(xs.shape)}")
    out = q.new_empty((b, s))
    if b and s:
        _call("rerank_l2_launch", q, q.data_ptr(), xs.data_ptr(),
              out.data_ptr(), b, s, d)
        launches["rerank_l2"] += 1
    return out


def rerank_l2_rows(q: torch.Tensor, vectors: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """q [B, D] f32; vectors [N, D] f32 (read in place); ids [B, S] int32
    -> [B, S] exact squared L2 of each lane's rows, INF where the id is
    -1."""
    if _use_plain(q, vectors, ids):
        return ref.rerank_l2_rows_ref(q, vectors, ids)
    _check(q, "q", torch.float32, 2)
    _check(vectors, "vectors", torch.float32, 2)
    _check(ids, "ids", torch.int32, 2)
    b, s = ids.shape
    n, d = vectors.shape
    if q.shape != (b, d):
        raise ValueError(f"rerank_l2_rows shapes: q {tuple(q.shape)}, "
                         f"vectors {(n, d)}, ids {(b, s)}")
    out = q.new_empty((b, s))
    if b and s:
        _call("rerank_l2_rows_launch", q, q.data_ptr(), vectors.data_ptr(),
              ids.data_ptr(), out.data_ptr(), b, s, d, n)
        launches["rerank_l2_rows"] += 1
    return out


def rerank_l2_shared(q: torch.Tensor, rows: torch.Tensor,
                     count: int) -> torch.Tensor:
    """q [B, D] f32; rows [S, D] f32, the same for every lane; count, a
    host int in [0, S] -> [B, S] exact squared L2 to rows ``< count``
    (within the rerank grade; on the card bit-equal to ``rerank_l2_rows``
    wherever the guard recomputes a pair, and on every pair with d under
    ``(SHARED_TAU - 2 SHARED_EPS) (||q'||^2 + ||x'||^2)``), INF from row
    ``count`` on."""
    if not 0 <= count <= rows.shape[0]:
        raise ValueError(f"rerank_l2_shared: count {count} outside "
                         f"[0, {rows.shape[0]}]")
    if _use_plain(q, rows):
        return ref.rerank_l2_shared_ref(q, rows, count)
    return rerank_l2_shared_guarded(q, rows, count, SHARED_TAU)


def rerank_l2_shared_guarded(q: torch.Tensor, rows: torch.Tensor,
                             count: int, tau: float,
                             flags: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The kernel of :func:`rerank_l2_shared` on CUDA tensors with the
    guard's threshold ``tau`` (``-inf``: no pair recomputed) and, where
    ``flags`` (a zeroed ``[B, S]`` uint8) is given, each recomputed pair
    marked 1 in it: ``chip_smoke.py`` measures the guard with these."""
    _check(q, "q", torch.float32, 2)
    _check(rows, "rows", torch.float32, 2)
    b, d = q.shape
    s = rows.shape[0]
    if rows.shape[1] != d or not 0 <= count <= s:
        raise ValueError(f"rerank_l2_shared shapes: q {tuple(q.shape)}, "
                         f"rows {tuple(rows.shape)}, count {count}")
    if d % 4 or d > SHARED_MAX_D or q.data_ptr() % 16 or \
            rows.data_ptr() % 16:
        raise ValueError(f"rerank_l2_shared: want D % 4 == 0, D <= "
                         f"{SHARED_MAX_D} and 16-byte aligned q and rows")
    if flags is not None:
        _check(flags, "flags", torch.uint8, 2)
        if flags.shape != (b, s) or flags.device != q.device:
            raise ValueError("rerank_l2_shared: flags must be [B, S]")
    out = q.new_empty((b, s))
    if b and s:
        _call("rerank_l2_shared_launch", q, q.data_ptr(), rows.data_ptr(),
              out.data_ptr(), 0 if flags is None else flags.data_ptr(),
              b, s, d, int(count), float(tau))
        launches["rerank_l2_shared"] += 1
    return out


def pool_merge(pool_d, pool_ids, new_d, new_ids):
    """Per lane, keep the P smallest of pool [B, P] ∪ new [B, Q], ascending
    and stable on ties -> (d [B, P] f32, ids [B, P] int32)."""
    if _use_plain(pool_d, pool_ids, new_d, new_ids):
        return ref.pool_merge_ref(pool_d, pool_ids, new_d, new_ids)
    return pool_merge_with_routes(pool_d, pool_ids, new_d, new_ids)


def pool_merge_with_routes(pool_d, pool_ids, new_d, new_ids, routes=None):
    """The kernel of :func:`pool_merge` on CUDA tensors, adding each lane's
    route to ``routes`` (a zeroed int64 ``[3]`` on the device, or None),
    in the order of ``POOL_MERGE_ROUTES``.  The route changes the
    kernel's speed, never its result; ``chip_smoke.py`` shows every route
    launched with it."""
    if not all(t.is_cuda for t in (pool_d, pool_ids, new_d, new_ids)):
        raise ValueError("pool_merge_with_routes: CUDA tensors only")
    for t, name, dt in ((pool_d, "pool_d", torch.float32),
                        (pool_ids, "pool_ids", torch.int32),
                        (new_d, "new_d", torch.float32),
                        (new_ids, "new_ids", torch.int32)):
        _check(t, name, dt, 2)
    b, p = pool_d.shape
    q = new_d.shape[1]
    if pool_ids.shape != (b, p) or new_d.shape[0] != b or \
            new_ids.shape != (b, q):
        raise ValueError("pool_merge: mismatched shapes")
    if p + q > POOL_MERGE_MAX:
        raise ValueError(f"pool_merge: P + Q = {p + q} > {POOL_MERGE_MAX}")
    if routes is not None:
        _check(routes, "routes", torch.int64, 1)
        if routes.shape != (len(POOL_MERGE_ROUTES),) or \
                routes.device != pool_d.device:
            raise ValueError("pool_merge: routes must be int64 [3] on the "
                             "inputs' device")
    out_d = pool_d.new_empty((b, p))
    out_i = pool_ids.new_empty((b, p))
    if b and p:
        _call("pool_merge_launch", pool_d, pool_d.data_ptr(),
              pool_ids.data_ptr(), new_d.data_ptr(), new_ids.data_ptr(),
              out_d.data_ptr(), out_i.data_ptr(),
              0 if routes is None else routes.data_ptr(), b, p, q)
        launches["pool_merge"] += 1
    return out_d, out_i


def pool_merge_chunked(pool_d, pool_ids, new_d, new_ids):
    """:func:`pool_merge` for any Q: the new block merges in successive
    chunks of at most ``POOL_MERGE_MAX - P`` entries, in order.  Each merge
    keeps its pool's entries before the chunk's on ties, so the chunks give
    exactly what one stable merge of pool, then the whole block, gives."""
    p, q = pool_d.shape[1], new_d.shape[1]
    step = POOL_MERGE_MAX - p
    if step <= 0:
        raise ValueError(f"pool_merge_chunked: P = {p} leaves no room")
    for lo in range(0, q, step):
        pool_d, pool_ids = pool_merge(
            pool_d, pool_ids, new_d[:, lo:lo + step].contiguous(),
            new_ids[:, lo:lo + step].contiguous())
    return pool_d, pool_ids


def entrance_smem_bytes(m: int, c: int) -> int:
    """entrance_search's shared memory a lane: the LUT (M x 256 floats),
    the pool's two buffers and the new block (distances and slots), the
    expanded bitmap over C slots."""
    return (m * 256 * 4 + (2 * ENTRANCE_MAX_POOL + ENTRANCE_MAX_DEG) * 8 +
            -(-c // 32) * 4)


def entrance_search(lut, codes, ent_ids, ent_edges, *, pool_size: int,
                    max_hops: int):
    """Every lane's whole entrance beam search, on CUDA tensors: lut [B,
    M, 256] f32, codes [N, M] uint8, the entrance's ids [C] and edges [C,
    R] int32 -> (main ids [B, pool_size] int32, -1 where empty; their PQ
    distances [B, pool_size] f32; each lane's iterations [B] int32; int64
    [2]: the largest and the summed iterations).  Bit-equal to the host
    loop (``core/search.py`` ``_entrance_loop``), its plain version, in
    either visited mode.  Kernel limits: pool_size <= 64, R <= 64, the LUT
    and a bitmap of C bits within 227 KB (M <= 225 at C 2,400)."""
    if not all(t.is_cuda for t in (lut, codes, ent_ids, ent_edges)):
        raise ValueError("entrance_search: CUDA tensors only")
    _check(lut, "lut", torch.float32, 3)
    _check(codes, "codes", torch.uint8, 2)
    _check(ent_ids, "ent_ids", torch.int32, 1)
    _check(ent_edges, "ent_edges", torch.int32, 2)
    b, m, k = lut.shape
    c, r = ent_edges.shape
    if k != 256 or codes.shape[1] != m or ent_ids.shape[0] != c or \
            len({t.get_device() for t in (lut, codes, ent_ids,
                                           ent_edges)}) != 1:
        raise ValueError(f"entrance_search shapes: lut {tuple(lut.shape)}, "
                         f"codes {tuple(codes.shape)}, ids "
                         f"{tuple(ent_ids.shape)}, edges {(c, r)}")
    if not (1 <= pool_size <= ENTRANCE_MAX_POOL and
            1 <= r <= ENTRANCE_MAX_DEG and c >= 1 and b < 2 ** 31) or \
            entrance_smem_bytes(m, c) > ENTRANCE_SMEM_MAX or \
            lut.data_ptr() % 16:
        raise ValueError(
            f"entrance_search limits: pool_size {pool_size} (1.."
            f"{ENTRANCE_MAX_POOL}), R {r} (1..{ENTRANCE_MAX_DEG}), C {c} "
            f">= 1, a 16-byte aligned LUT and {entrance_smem_bytes(m, c)} "
            f"bytes of shared memory (<= {ENTRANCE_SMEM_MAX})")
    main = ent_ids.new_empty((b, pool_size))
    dist = lut.new_empty((b, pool_size))
    hops = ent_ids.new_empty((b,))
    tally = ent_ids.new_zeros((2,), dtype=torch.int64)
    if b:
        _call("entrance_search_launch", lut, lut.data_ptr(),
              codes.data_ptr(), ent_ids.data_ptr(), ent_edges.data_ptr(),
              main.data_ptr(), dist.data_ptr(), hops.data_ptr(),
              tally.data_ptr(), b, m, pool_size, r, c, int(max_hops))
        launches["entrance_search"] += 1
    return main, dist, hops, tally


def casr_rerank(q, vectors, pool_ids, *, k: int, s: int):
    """CASR's group loop for a wave: q [B, D] f32, vectors [N, D] f32 (read
    in place), PQ-sorted pool_ids [B, P] int32 (-1 tail), groups of s.
    Returns (exact_d [B, P] f32, loaded [B, P] bool, topk_ids [B, k]
    int32, topk_d [B, k] f32, n_loaded [B] int64, rounds [B] int32).
    Kernel limits: P <= 256, 1 <= s <= P, 1 <= k <= P, D <= 8192,
    B <= 65535."""
    if _use_plain(q, vectors, pool_ids):
        return ref.casr_rerank_ref(q, vectors, pool_ids, k, s)
    _check(q, "q", torch.float32, 2)
    _check(vectors, "vectors", torch.float32, 2)
    _check(pool_ids, "pool_ids", torch.int32, 2)
    b, p = pool_ids.shape
    n, d = vectors.shape
    if q.shape != (b, d):
        raise ValueError(f"casr_rerank shapes: q {tuple(q.shape)}, vectors "
                         f"{tuple(vectors.shape)}, pool_ids {(b, p)}")
    if not (1 <= p <= 256 and 1 <= s <= p and 1 <= k <= p and
            1 <= d <= 8192 and b <= 65535):
        raise ValueError(f"casr_rerank limits: P={p} (1..256), s={s} "
                         f"(1..P), k={k} (1..P), D={d} (1..8192), "
                         f"B={b} (<= 65535)")
    exact_d = q.new_empty((b, p))
    loaded = q.new_empty((b, p), dtype=torch.bool)
    topk_ids = pool_ids.new_empty((b, k))
    topk_d = q.new_empty((b, k))
    n_loaded = pool_ids.new_empty((b,), dtype=torch.int64)
    rounds = pool_ids.new_empty((b,))
    if b:
        _call("casr_rerank_launch", q, q.data_ptr(), vectors.data_ptr(),
              pool_ids.data_ptr(), exact_d.data_ptr(), loaded.data_ptr(),
              topk_ids.data_ptr(), topk_d.data_ptr(), n_loaded.data_ptr(),
              rounds.data_ptr(), b, p, d, n, k, s)
        launches["casr_rerank"] += 1
    return exact_d, loaded, topk_ids, topk_d, n_loaded, rounds


def casr_rerank_stages(vectors: torch.Tensor, p: int, k: int, s: int) -> int:
    """The ring stages :func:`casr_rerank`'s kernel runs with for a store
    ``vectors`` on the card, pools of ``p``, top-``k`` and groups of
    ``s``: two (one group prefetched past the one a round consumes), or 0
    where it reads each group's rows straight from device memory."""
    if not _entry:
        _resolve()
    return int(_entry["casr_rerank_stages"](
        vectors.data_ptr(), p, vectors.shape[1], k, s))


def cache_smem_bytes(w: int, f: int) -> int:
    """The cache kernels' shared memory for W window and F frozen slots, as
    their ``Layout`` places it: 32 installs' draws (24 bytes each), the
    input's next 32 entries, 8 counters, 32 leftovers of the map's
    build, the map's keys and 2-byte locations in 5 (W + F) / 12 buckets of
    4 slots, the window's pages, stamps and hits, the frozen pages and
    stamps, the empty-slot bitmap's two levels, each location's slot, the
    window list's two links; each table aligned to its element (a bucket
    to 16 and 8 bytes), the whole to 16 bytes."""
    r = w + f
    nb = max((5 * r + 11) // 12, 2)
    n_emp = -(-w // 32)
    at = 0
    for n, align in ((32 * 24, 8), (32 * 4, 4), (8 * 4, 4), (32 * 4, 4),
                     (nb * 16, 16), (nb * 8, 8), (w * 4, 4), (w * 4, 4),
                     (w * 4, 4), (f * 4, 4), (f * 4, 4), (n_emp * 4, 4),
                     (-(-n_emp // 32) * 4, 4), (r * 2, 2), (w * 2, 2),
                     (w * 2, 2)):
        at = -(-at // align) * align + n
    return -(-at // 16) * 16


def _check_cache(tables) -> tuple[int, int, int]:
    """Check a cache state's tensors (``CACHE_TABLES``' order) for the
    kernel; returns (W, F, P_max)."""
    if len(tables) != len(CACHE_TABLES):
        raise ValueError(f"cache kernels take {len(CACHE_TABLES)} tensors, "
                         f"got {len(tables)}")
    for t, (name, dtype, ndim) in zip(tables, CACHE_TABLES):
        _check(t, name, dtype, ndim)
    p, w, f = tables[0].shape[0], tables[3].shape[0], tables[5].shape[0]
    if (tables[1].shape[0] != p or tables[2].shape[0] != p or
            tables[4].shape[0] != w or tables[6].shape[0] != f or
            tables[10].shape[0] != 2 or w < 1 or f < 1):
        raise ValueError("cache tables: mismatched shapes")
    if p >= 1 << 29:
        raise ValueError(f"cache kernels: P_max {p} >= 2**29 pages")
    if cache_smem_bytes(w, f) > CACHE_SMEM_MAX:
        raise ValueError(f"cache kernels: the region tables and the map of "
                         f"W {w} + F {f} slots do not fit shared memory")
    return w, f, p


def _table_ptrs(tables) -> list[int]:
    return [t.data_ptr() for t in tables]


def cache_replay(policy: int, tables, traces: torch.Tensor) -> torch.Tensor:
    """Replay trace rows ``traces`` [Q, T] int32 (each up to its first -1)
    in wave order into the cache state ``tables`` (``CACHE_TABLES``'
    order), in place.  Returns the replay's hit count, int32 [1]."""
    if _use_plain(*tables, traces):
        return ref.cache_apply(policy, tables, traces=traces)
    w, f, p = _check_cache(tables)
    _check(traces, "traces", torch.int32, 2)
    q, t = traces.shape
    out = traces.new_zeros((1,))
    if q and t:
        _call("cache_replay_launch", traces, *_table_ptrs(tables),
              traces.data_ptr(), out.data_ptr(), q, t, w, f, p, int(policy))
        launches["cache_replay"] += 1
    return out


def cache_ops(policy: int, tables, pages: torch.Tensor,
              kinds: torch.Tensor | None = None,
              kind: int = ACCESS) -> torch.Tensor:
    """Run the operations ``pages`` [N] int32 (-1 skipped) of ``kinds`` [N]
    int8 (``ACCESS``, ``INVALIDATE``, ``PRIORITY_ADMIT``; or ``kind`` for
    all where ``kinds`` is None) in order on the cache state ``tables``, in
    place.  Returns the accesses' hit count, int32 [1]."""
    extra = () if kinds is None else (kinds,)
    if _use_plain(*tables, pages, *extra):
        return ref.cache_apply(policy, tables, pages=pages, kinds=kinds,
                               kind=kind)
    w, f, p = _check_cache(tables)
    _check(pages, "pages", torch.int32, 1)
    n = pages.shape[0]
    if kinds is not None:
        _check(kinds, "kinds", torch.int8, 1)
        if kinds.shape[0] != n:
            raise ValueError(f"cache_ops: {n} pages, {kinds.shape[0]} kinds")
    if kind not in (ACCESS, INVALIDATE, PRIORITY_ADMIT):
        raise ValueError(f"cache_ops: unknown kind {kind}")
    out = pages.new_zeros((1,))
    if n:
        _call("cache_ops_launch", pages, *_table_ptrs(tables),
              pages.data_ptr(), 0 if kinds is None else kinds.data_ptr(),
              out.data_ptr(), n, int(kind), w, f, p, int(policy))
        launches["cache_ops"] += 1
    return out
