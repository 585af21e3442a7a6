// cache_replay / cache_ops: the NAVIS host cache's state machine (and the
// LRU, CLOCK, LFU and no-cache baselines) run on the card, in place on a
// CacheState's tensors.
//
// Replaces no Pallas kernel.  Its counterpart is the reference's jitted
// replay (src/repro/core/cache.py): `apply_traces` / `apply_trace` (a
// lax.while_loop inside a lax.scan, :222-272), `access` (:275),
// `priority_admit` (:309) and `invalidate_page` (:330), a loop XLA
// compiles for the TPU.  `cache_replay` replays trace rows [Q, T] in wave
// order, each row up to its first -1; `cache_ops` runs a flat stream of
// (kind, page) operations (ACCESS, INVALIDATE, PRIORITY_ADMIT), skipping
// -1 pages: a threaded traversal's charged pages, a commit's eviction
// hints and its entrance admit.  Both write the run's hit count to
// hits_out[0].
//
// What bounds it on an H100: a dependent serial chain.  Every access reads
// the state the previous one left, so no two accesses overlap; the bytes
// it must move (the trace plus the few table entries each access touches,
// at 3.35 TB/s) take microseconds for a wave of ~20,000 accesses that
// runs for a millisecond or more.  Its time is the chain's length times
// the latency of one access: the design keeps every read the chain waits
// on in shared memory, makes each victim search O(1) where it can, and
// moves what does not depend on the cache (the random draws, the input)
// off the chain.
//
// Design: one block of kThreads, one kernel a policy (so the chain has no
// policy branch).  Warp 0 runs the chain, every lane computing the same
// values from the same shared-memory reads and storing them too (the same
// value to the same address: no lane waits on another, and no branch
// diverges); warp 1 draws the NAVIS installs' randoms ahead; the block
// stages.
// - The region tables (window_pages, window_last [W], frozen_pages,
//   frozen_last [F]) live in dynamic shared memory for the whole run, with
//   the window's hits by slot beside them (LFU's victim and the NAVIS
//   window hit read them; no path reads a frozen or an uncached page's
//   hits, only writes them).
// - A resident map, page -> location (window slot i as i, frozen slot j as
//   W + j), for the <= W + F resident pages: two-choice hashing into
//   buckets of 4 slots, 5 (W + F) / 12 buckets (at most 60% full), so a
//   lookup reads its page's two buckets (two 16-byte keys and two 8-byte
//   locations, at once) and compares 8 keys; an insert takes a free slot
//   of the two, else moves residents to their other bucket, each from a
//   slot hashed from the resident in hand and the move's count; a
//   deletion empties its slot, found through each location's slot
//   (posof), with no probe.
// - The window's LRU victim (NAVIS, LRU) is O(1): the non-empty window
//   slots in a doubly linked list by (stamp, slot), whose head is the
//   argmin (a hit moves its slot to the tail, its stamp the newest), and
//   the empty slots (stamp -1, before every stamp) in a two-level bitmap
//   whose first set bit is the first empty slot.  LFU takes the first
//   empty slot too, else the warp's argmin of the hits (two reductions);
//   CLOCK scans from the hand 32 slots at a time and stops at the first
//   slot not used in the last 64 ticks.  Ties go to the first index, as
//   jnp.argmin's.
// - The page tables (status, hits, slot_of [P_max]) stay in device memory
//   and the chain writes them through at every change, as the reference
//   updates them; the chain never reads them, so it never waits on device
//   memory, and the tables end bit-equal to the host replay's.  The
//   reference's quirks stay: a page evicted from the frozen region keeps
//   its hits, and frozen_fill counts a refilled slot twice.
// - The threefry key's chain of splits does not depend on the cache: warp
//   1 computes each install's new key and eight probes (threefry-2x32,
//   bit-exact with jax.random's split and randint) up to 32 installs
//   ahead into a ring in shared memory, and the chain reads them there.
// - The prologue (every thread) stages the region tables, checks the map's
//   premise for each resident page (status IN_WINDOW / IN_FROZEN and
//   slot_of its slot; a page past P_max or listed twice fails it too; an
//   empty window slot has stamp -1 and a full one a stamp >= 0) and traps
//   on a violation, orders the window's list by rank, builds the map with
//   atomicCAS (the chain inserts the rare page both of whose buckets are
//   full) and loads the window's hits; the epilogue writes the region
//   tables back.  Trace rows and op streams are read 32 entries at a time
//   into shared memory (an operation's page and kind packed in one), the
//   next 32 loaded while these run, each entry read there one ahead.  A
//   page id past P_max traps: a write past the tables would corrupt the
//   state silently.
//
// Shared memory: 8 (W + F) bytes of region tables, 4 W of window hits,
// 10 (W + F) of map (a 4-byte key and a 2-byte location a slot, 4 slots a
// bucket, 5 (W + F) / 12 buckets), 2 (W + F) of slot positions, 4 W of
// list links, W / 8 of bitmap and 1,056 of draws, input, counters and the
// build's leftovers: at most 232,448 (227 KB), so W + F <= 8,225 slots
// whatever the split (ops.cache_smem_bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNotCached = 0, kInWindow = 1, kInFrozen = 2;
constexpr int kNavis = 0, kLru = 1, kClock = 2, kLfu = 3, kNone = 4;
constexpr int kAccess = 0, kInvalidate = 1, kPriorityAdmit = 2;
constexpr int kProbes = 8;       // randomized-eviction probe budget
constexpr int kInuseTicks = 64;  // "currently in use" guard
constexpr int kThreads = 256;    // the block: warp 0 the chain, all staging
constexpr int kEmpty = -1;       // an empty map slot
constexpr int kDraws = 32;       // installs drawn ahead, at most
constexpr int kOver = 32;        // pages the build leaves over, listed
constexpr uint16_t kUnplaced = 0xffff;  // a location the build left over
constexpr int kMaxKicks = 1024;  // a displacement chain, at most
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, on counter (x1, x2) under key (k1, k2): the
// hash of jax.random (and of repro_torch/random.py).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// The warp's minimum of v and the first index i holding it (each lane's i
// its first index of its own minimum): two warp reductions.
__device__ __forceinline__ int warp_argmin(int v, int i) {
  const int m = __reduce_min_sync(kAll, v);
  return __reduce_min_sync(kAll, v == m ? i : 0x7fffffff);
}

// One frozen install's draws: the key after it and its eight probes.
struct Draw {
  uint32_t k1, k2;
  uint16_t probe[kProbes];
};

// The shared-memory layout for W window and F frozen slots (byte offsets,
// each table aligned to its element; ops.cache_smem_bytes mirrors it).
__host__ __device__ inline size_t take(size_t& at, size_t n, size_t align) {
  at = (at + align - 1) / align * align;
  const size_t here = at;
  at += n;
  return here;
}

struct Layout {
  int W, F, R, NB, n_emp, n_top;
  size_t wp, wl, wh, fp, fl, key, loc, posof, nxt, prv, emp, top, draws,
      chunk, flags, over, bytes;

  __host__ __device__ Layout(int w, int f) : W(w), F(f), R(w + f) {
    NB = (5 * R + 11) / 12 > 2 ? (5 * R + 11) / 12 : 2;
    n_emp = (W + 31) / 32;
    n_top = (n_emp + 31) / 32;
    size_t at = 0;
    draws = take(at, kDraws * sizeof(Draw), 8);
    chunk = take(at, 32 * 4, 4);     // the input's next 32 entries
    flags = take(at, 8 * 4, 4);      // produced, consumed, stop, counts
    over = take(at, kOver * 4, 4);   // pages the parallel build left over
    key = take(at, (size_t)NB * 16, 16);
    loc = take(at, (size_t)NB * 8, 8);
    wp = take(at, (size_t)W * 4, 4);
    wl = take(at, (size_t)W * 4, 4);
    wh = take(at, (size_t)W * 4, 4);
    fp = take(at, (size_t)F * 4, 4);
    fl = take(at, (size_t)F * 4, 4);
    emp = take(at, (size_t)n_emp * 4, 4);
    top = take(at, (size_t)n_top * 4, 4);
    posof = take(at, (size_t)R * 2, 2);
    nxt = take(at, (size_t)W * 2, 2);
    prv = take(at, (size_t)W * 2, 2);
    bytes = (at + 15) / 16 * 16;
  }
};

__device__ __forceinline__ int map_bucket1(int page, int NB) {
  return (int)(((unsigned long long)((uint32_t)page * 0x9E3779B1u) *
                (unsigned)NB) >> 32);
}

__device__ __forceinline__ int map_bucket2(int page, int NB) {
  const int a = map_bucket1(page, NB);
  const int b = (int)(((unsigned long long)((uint32_t)page * 0x85EBCA77u) *
                       (unsigned)NB) >> 32);
  return b != a ? b : (a + 1 == NB ? 0 : a + 1);
}

// The slot of its bucket that a displacement's n-th move takes, hashed
// from the page in hand and n.  The slot after the last, in turn, made the
// walk a function of the map alone, and on some maps (the prologue's
// parallel build lays the residents out in a different order each launch)
// it circled among a few full buckets until the trap: in about one replay
// of a FineWeb-like wave of 10,000 in 140 on an H100.
__device__ __forceinline__ int kick_slot(int page, int n) {
  uint32_t h = (uint32_t)page * 0x27D4EB2Fu + (uint32_t)n * 0x165667B1u;
  h ^= h >> 15;
  return (int)((h * 0x2C1B3C6Du) >> 30);
}

// Put `page` at location l where both its buckets are full: move the
// resident of one of its slots (kick_slot) to that resident's other
// bucket, until one finds an empty slot.  Rare, so out of line: the
// chain's loop stays small.
__device__ __noinline__ void displace(int* key, uint16_t* loc,
                                      uint16_t* posof, int NB, int page,
                                      int l) {
  int b = map_bucket1(page, NB);
  for (int n = 0; n < kMaxKicks; ++n) {
    const int slot = 4 * b + kick_slot(page, n);
    const int out = key[slot], out_l = loc[slot];
    key[slot] = page;
    loc[slot] = (uint16_t)l;
    posof[l] = (uint16_t)slot;
    page = out;
    l = out_l;
    b = b == map_bucket1(page, NB) ? map_bucket2(page, NB)
                                   : map_bucket1(page, NB);
    const int4 k = reinterpret_cast<const int4*>(key)[b];
    const int e = k.x == kEmpty ? 0 : k.y == kEmpty ? 1
                : k.z == kEmpty ? 2 : k.w == kEmpty ? 3 : -1;
    if (e >= 0) {
      key[4 * b + e] = page;
      loc[4 * b + e] = (uint16_t)l;
      posof[l] = (uint16_t)(4 * b + e);
      return;
    }
  }
  __trap();                               // no room: cannot happen at 60%
}

template <int POLICY>
struct Chain {
  static constexpr bool kList = POLICY == kNavis || POLICY == kLru;
  static constexpr bool kEmpties = kList || POLICY == kLfu;

  int8_t* status;  // [P] device memory, written through
  int* hits;
  int* slot_of;
  int* wp;  // shared: window_pages [W], window_last [W], window hits [W]
  int* wl;
  int* wh;
  int* fp;  // shared: frozen_pages [F], frozen_last [F]
  int* fl;
  int* key;        // the map: key [NB][4], loc [NB][4], posof [W + F]
  uint16_t* loc;
  uint16_t* posof;
  int16_t* nxt;    // the window's list: links [W]
  int16_t* prv;
  unsigned* emp;   // empty window slots: bits [W / 32], words [W / 1024]
  unsigned* top;
  volatile Draw* draws;
  volatile int* produced;
  volatile int* consumed;
  int P, W, F, NB, lane;
  int fill, hand, clock;        // registers, the same in every lane
  int installs, head, tail, n_empty;
  uint32_t k1, k2;

  __device__ __forceinline__ void check(int page) const {
    if (page >= P) __trap();
  }

  // -- the map: two buckets of 4 slots a page --------------------------------

  __device__ __forceinline__ int bucket1(int page) const {
    return map_bucket1(page, NB);
  }

  __device__ __forceinline__ int bucket2(int page) const {
    return map_bucket2(page, NB);
  }

  // The page's location, or -1; `pos` is its slot, or (a miss) the first
  // empty slot of its two buckets, -1 if both are full.  The 8 keys and
  // locations in four loads at once, the matches as bit masks.
  __device__ __forceinline__ int find(int page, int& pos) const {
    const int a = bucket1(page), b = bucket2(page);
    const int4 ka = reinterpret_cast<const int4*>(key)[a];
    const int4 kb = reinterpret_cast<const int4*>(key)[b];
    const uint2 la = reinterpret_cast<const uint2*>(loc)[a];
    const uint2 lb = reinterpret_cast<const uint2*>(loc)[b];
    auto bits = [](int4 k, int v) {
      return (unsigned)(k.x == v) | (unsigned)(k.y == v) << 1 |
             (unsigned)(k.z == v) << 2 | (unsigned)(k.w == v) << 3;
    };
    const unsigned hit = bits(ka, page) | bits(kb, page) << 4;
    const unsigned emp_ = bits(ka, kEmpty) | bits(kb, kEmpty) << 4;
    const int i = __ffs(hit ? hit : emp_) - 1;     // no branch: the loads
    const uint2 lw = i & 4 ? lb : la;              // go out together
    const unsigned w = i & 2 ? lw.y : lw.x;
    pos = i < 0 ? -1 : (i < 4 ? 4 * a : 4 * b - 4) + i;
    return hit ? (int)((w >> (16 * (i & 1))) & 0xffffu) : -1;
  }

  __device__ __forceinline__ void put(int pos, int page, int l) {
    key[pos] = page;
    loc[pos] = (uint16_t)l;
    posof[l] = (uint16_t)pos;
  }

  // Insert `page` at location l: at `pos` (an empty slot of its buckets),
  // else through displace().
  __device__ __forceinline__ void insert(int page, int l, int pos) {
    if (pos >= 0)
      put(pos, page, l);
    else
      displace(key, loc, posof, NB, page, l);
  }

  // -- the window's victim structures -------------------------------------

  __device__ __forceinline__ int first_empty() const {
    for (int s = 0;; ++s) {
      const unsigned t = top[s];
      if (t) {
        const int w = 32 * s + __ffs(t) - 1;
        return 32 * w + __ffs(emp[w]) - 1;
      }
    }
  }

  __device__ __forceinline__ void set_empty(int slot) {
    const int w = slot >> 5;
    emp[w] |= 1u << (slot & 31);
    top[w >> 5] |= 1u << (w & 31);
    n_empty += 1;
  }

  __device__ __forceinline__ void set_full(int slot) {
    const int w = slot >> 5;
    const unsigned left = emp[w] & ~(1u << (slot & 31));
    emp[w] = left;
    if (left == 0) top[w >> 5] &= ~(1u << (w & 31));
    n_empty -= 1;
  }

  __device__ __forceinline__ void unlink(int s) {
    const int p = prv[s], n = nxt[s];
    if (p >= 0)
      nxt[p] = (int16_t)n;
    else
      head = n;
    if (n >= 0)
      prv[n] = (int16_t)p;
    else
      tail = p;
  }

  __device__ __forceinline__ void push_tail(int s) {
    prv[s] = (int16_t)tail;
    nxt[s] = -1;
    if (tail >= 0)
      nxt[tail] = (int16_t)s;
    else
      head = s;
    tail = s;
  }

  // The window slot an admit takes.
  __device__ __forceinline__ int victim() {
    if (kList) return n_empty > 0 ? first_empty() : head;
    return scan_victim();
  }

  __device__ int scan_victim() {
    if (POLICY == kClock) {
      for (int j0 = 0; j0 < W; j0 += 32) {
        const int j = j0 + lane;
        int idx = hand + j;
        idx = idx < W ? idx : idx - W;
        const bool old = j < W && clock - wl[idx] >= kInuseTicks;
        const unsigned any = __ballot_sync(kAll, old);
        if (any) {
          const int b = hand + j0 + __ffs(any) - 1;
          return b < W ? b : b - W;
        }
      }
      return hand % W;
    }
    if (n_empty > 0) return first_empty();
    int v = 0x7fffffff, idx = 0x7fffffff;      // LFU: the first least hit
    for (int i = lane; i < W; i += 32) {
      if (wh[i] < v) {
        v = wh[i];
        idx = i;
      }
    }
    return warp_argmin(v, idx);
  }

  // -- the operations (every lane stores the same values) -----------------

  // Put `page` (a miss; `pos` the empty slot its lookup found) into window
  // slot `v`, evicting its page.
  __device__ __forceinline__ void admit_window(int page, int pos, int v) {
    const int old = wp[v];
    if (old >= 0) {
      status[old] = kNotCached;
      slot_of[old] = -1;
      hits[old] = 0;
      const int op = posof[v];
      key[op] = kEmpty;
      pos = pos >= 0 ? pos : (op >> 2 == bucket1(page) ||
                              op >> 2 == bucket2(page) ? op : -1);
    }
    status[page] = kInWindow;
    slot_of[page] = v;
    hits[page] = 1;
    wp[v] = page;
    wl[v] = clock;
    wh[v] = 1;
    insert(page, v, pos);
    if (kList) {
      if (old >= 0)
        unlink(v);
      else
        set_full(v);
      push_tail(v);
    } else if (kEmpties && old < 0) {
      set_full(v);
    }
    if (POLICY == kClock) hand = v + 1 == W ? 0 : v + 1;
  }

  // Move `page` (not frozen; window slot `ws`, or -1 where not cached, and
  // `pos` its map slot, or the empty slot its lookup found) into the
  // frozen region with the next draw (the key split, eight probes drawn
  // with randint(sub, (8,), 0, F): warp 1's): take the first probe of the
  // lowest score (0 empty, 1 not used in the last 64 ticks, 2 else), evict
  // its page and drop `page` from the window if it sits there.
  __device__ void install_frozen(int page, int ws, int pos) {
    while (*produced <= installs) {
    }
    volatile Draw& dr = draws[installs % kDraws];
    const int probe = lane < kProbes ? (int)dr.probe[lane] : 0;
    const uint32_t nk1 = dr.k1, nk2 = dr.k2;
    const bool empty = lane < kProbes && fp[probe] < 0;
    const bool idle = lane < kProbes && clock - fl[probe] >= kInuseTicks;
    const unsigned b0 = __ballot_sync(kAll, empty);          // score 0
    const unsigned b1 = __ballot_sync(kAll, idle);           // 1 (no 0)
    const int v = __shfl_sync(kAll, probe,
                              b0 ? __ffs(b0) - 1 : b1 ? __ffs(b1) - 1 : 0);
    const int old = fp[v];
    if (old >= 0) {
      status[old] = kNotCached;
      slot_of[old] = -1;
      key[posof[W + v]] = kEmpty;
    }
    status[page] = kInFrozen;
    slot_of[page] = v;
    fp[v] = page;
    fl[v] = clock;
    if (ws >= 0) {
      wp[ws] = -1;
      wl[ws] = -1;
      wh[ws] = 0;
      loc[pos] = (uint16_t)(W + v);       // its slot stays
      posof[W + v] = (uint16_t)pos;
      unlink(ws);
      set_empty(ws);
    } else {
      if (pos < 0 && old >= 0) {
        const int op = posof[W + v];
        pos = op >> 2 == bucket1(page) || op >> 2 == bucket2(page) ? op : -1;
      }
      insert(page, W + v, pos);
    }
    *consumed = installs + 1;
    fill += old >= 0 ? 0 : 1;
    k1 = nk1;
    k2 = nk2;
    installs += 1;
  }

  // One operation on `page`: an access (tick, look up, update; returns
  // whether it hit), the eviction hint (drop the page from its region and
  // its tables) or the priority admit (NAVIS only: straight into the
  // frozen region, a frozen page only stamped; no tick).  One lookup
  // serves the three, so the op stream's loop stays one path.
  __device__ __forceinline__ bool step(int page, int kind) {
    check(page);
    if (kind == kAccess) clock += 1;
    if (POLICY == kNone || (POLICY != kNavis && kind == kPriorityAdmit))
      return false;
    int pos;
    const int l = find(page, pos);
    if (kind == kInvalidate) {
      if (l >= 0) {
        if (l < W) {
          wp[l] = -1;
          wl[l] = -1;
          wh[l] = 0;
          if (kList) unlink(l);
          if (kEmpties) set_empty(l);
        } else {
          fp[l - W] = -1;
        }
        status[page] = kNotCached;
        slot_of[page] = -1;
        hits[page] = 0;
        key[pos] = kEmpty;
      }
      return false;
    }
    if (l >= W) {                         // frozen (NAVIS only)
      fl[l - W] = clock;
    } else if (kind == kPriorityAdmit) {
      install_frozen(page, l, pos);
    } else if (l >= 0) {                  // the window
      const int h = wh[l] + 1;
      wh[l] = h;
      hits[page] = h;
      wl[l] = clock;
      if (POLICY == kNavis && h >= 2) {
        install_frozen(page, l, pos);
      } else if (kList) {
        unlink(l);
        push_tail(l);
      }
    } else {
      admit_window(page, pos, victim());
    }
    return kind == kAccess && l >= 0;
  }
};

// Warp 1 (NAVIS): each install's new key and probes, drawn ahead; stops
// when the chain is done.  A pipeline of three threefry stages, one
// round of it a threefry's latency: lanes 0-1 split the key (its new key
// and sub, draw t), lanes 2-3 split the last sub (k_hi, k_lo, draw t - 1),
// lanes 16-31 draw the eight probes' high and low words (draw t - 2).
__device__ void produce_draws(volatile Draw* draws, volatile int* produced,
                              volatile int* consumed, volatile int* stop,
                              uint32_t k1, uint32_t k2, int F, int lane) {
  const uint32_t span = (uint32_t)(F > 1 ? F : 1);
  const uint32_t m16 = 65536u % span;
  const uint32_t mult = (m16 * m16) % span;
  uint32_t s1 = 0, s2 = 0, h1 = 0, h2 = 0, l1 = 0, l2 = 0;
  uint32_t p1 = 0, p2 = 0, q1 = 0, q2 = 0;   // the keys after t - 1, t - 2
  for (int t = 0;; ++t) {
    uint32_t in1 = 0, in2 = 0, c = 0;
    if (lane < 2) {
      in1 = k1;
      in2 = k2;
      c = (uint32_t)lane;
    } else if (lane < 4) {
      in1 = s1;
      in2 = s2;
      c = (uint32_t)lane - 2;
    } else if (lane >= 16) {
      in1 = lane < 24 ? h1 : l1;
      in2 = lane < 24 ? h2 : l2;
      c = (uint32_t)(lane & 7);
    }
    uint32_t a = 0, b = c;
    threefry2x32(in1, in2, a, b);
    const uint32_t nk1 = __shfl_sync(kAll, a, 0);   // key, sub: lanes 0-1
    const uint32_t nk2 = __shfl_sync(kAll, b, 0);
    const uint32_t ns1 = __shfl_sync(kAll, a, 1);
    const uint32_t ns2 = __shfl_sync(kAll, b, 1);
    const uint32_t nh1 = __shfl_sync(kAll, a, 2);   // k_hi, k_lo: lanes 2-3
    const uint32_t nh2 = __shfl_sync(kAll, b, 2);
    const uint32_t nl1 = __shfl_sync(kAll, a, 3);
    const uint32_t nl2 = __shfl_sync(kAll, b, 3);
    const uint32_t word = a ^ b;           // 16-23 higher, 24-31 lower
    const uint32_t lower = __shfl_sync(kAll, word, (lane + 8) & 31);
    if (t >= 2) {                          // draw t - 2 is complete
      const int n = t - 2;
      while (n - *consumed >= kDraws)
        if (*stop) return;
      volatile Draw& dr = draws[n % kDraws];
      if (lane >= 16 && lane < 24)
        dr.probe[lane - 16] =
            (uint16_t)(((word % span) * mult + lower % span) % span);
      if (lane == 0) {
        dr.k1 = q1;
        dr.k2 = q2;
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *produced = n + 1;
      }
    }
    if (*stop) return;
    q1 = p1;
    q2 = p2;
    p1 = nk1;
    p2 = nk2;
    k1 = nk1;
    k2 = nk2;
    s1 = ns1;
    s2 = ns2;
    h1 = nh1;
    h2 = nh2;
    l1 = nl1;
    l2 = nl2;
  }
}

// The whole run: prologue, the chain over the input (trace rows, or the
// op stream), epilogue.
template <int POLICY>
__device__ void run(int8_t* status, int* hits, int* slot_of,
                    int* window_pages, int* window_last, int* frozen_pages,
                    int* frozen_last, int* frozen_fill, int* clock_hand,
                    int* clock, long long* key, const int* traces,
                    const int* pages, const int8_t* kinds, int* hits_out,
                    int Q, int T, int N, int kind, int W, int F, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(W, F);
  const int R = L.R, NB = L.NB, tid = threadIdx.x;
  Chain<POLICY> m;
  m.status = status;
  m.hits = hits;
  m.slot_of = slot_of;
  m.wp = reinterpret_cast<int*>(smem + L.wp);
  m.wl = reinterpret_cast<int*>(smem + L.wl);
  m.wh = reinterpret_cast<int*>(smem + L.wh);
  m.fp = reinterpret_cast<int*>(smem + L.fp);
  m.fl = reinterpret_cast<int*>(smem + L.fl);
  m.key = reinterpret_cast<int*>(smem + L.key);
  m.loc = reinterpret_cast<uint16_t*>(smem + L.loc);
  m.posof = reinterpret_cast<uint16_t*>(smem + L.posof);
  m.nxt = reinterpret_cast<int16_t*>(smem + L.nxt);
  m.prv = reinterpret_cast<int16_t*>(smem + L.prv);
  m.emp = reinterpret_cast<unsigned*>(smem + L.emp);
  m.top = reinterpret_cast<unsigned*>(smem + L.top);
  volatile Draw* draws = reinterpret_cast<volatile Draw*>(smem + L.draws);
  int* chunk = reinterpret_cast<int*>(smem + L.chunk);
  volatile int* flags = reinterpret_cast<volatile int*>(smem + L.flags);
  int* counts = reinterpret_cast<int*>(smem + L.flags);  // [3] empty slots,
                                                          // [4] left over
  int* over = reinterpret_cast<int*>(smem + L.over);
  m.draws = draws;
  m.produced = flags;
  m.consumed = flags + 1;
  volatile int* stop = flags + 2;
  // the sizes in registers for the chain, not reloaded from the kernel's
  // parameters at each use
  int rP = P, rW = W, rF = F, rNB = NB;
  asm volatile("" : "+r"(rP), "+r"(rW), "+r"(rF), "+r"(rNB));
  m.P = rP;
  m.W = rW;
  m.F = rF;
  m.NB = rNB;
  m.lane = tid & 31;

  // -- prologue: stage, check the premise, order the list, build the map ---
  for (int i = tid; i < W; i += kThreads) {
    m.wp[i] = window_pages[i];
    m.wl[i] = window_last[i];
  }
  for (int i = tid; i < F; i += kThreads) {
    m.fp[i] = frozen_pages[i];
    m.fl[i] = frozen_last[i];
  }
  for (int i = tid; i < L.n_emp; i += kThreads) m.emp[i] = 0;
  for (int i = tid; i < L.n_top; i += kThreads) m.top[i] = 0;
  if (tid < 8) counts[tid] = 0;
  __syncthreads();
  // the list by rank of (stamp, slot), in key[] for now: an empty slot
  // (stamp -1, before every stamp) ranks nowhere
  int16_t* ord = reinterpret_cast<int16_t*>(m.key);
  for (int i = tid; i < W; i += kThreads) {
    const int s = m.wl[i];
    if ((m.wp[i] < 0) != (s == -1) || s < -1) __trap();  // the premise
    if (s < 0) {
      if (Chain<POLICY>::kEmpties) {
        atomicOr(&m.emp[i >> 5], 1u << (i & 31));
        atomicOr(&m.top[i >> 10], 1u << ((i >> 5) & 31));
      }
      atomicAdd(&counts[3], 1);
      continue;
    }
    if (!Chain<POLICY>::kList) continue;
    int rank = 0;
    for (int j = 0; j < W; ++j) {
      const int o = m.wl[j];
      rank += o >= 0 && (o < s || (o == s && j < i)) ? 1 : 0;
    }
    ord[rank] = (int16_t)i;
  }
  __syncthreads();
  const int n_empty = counts[3];
  if (Chain<POLICY>::kList)
    for (int r = tid; r < W - n_empty; r += kThreads) {
      const int s = ord[r];
      m.prv[s] = (int16_t)(r > 0 ? ord[r - 1] : -1);
      m.nxt[s] = (int16_t)(r + 1 < W - n_empty ? ord[r + 1] : -1);
    }
  const int head = W - n_empty > 0 ? ord[0] : -1;
  const int tail = W - n_empty > 0 ? ord[W - n_empty - 1] : -1;
  __syncthreads();
  for (int i = tid; i < 4 * NB; i += kThreads) m.key[i] = kEmpty;
  for (int i = tid; i < R; i += kThreads) m.posof[i] = kUnplaced;
  __syncthreads();
  // each resident page into the first free slot of its two buckets
  // (atomicCAS, every thread at once); a page that finds both full is left
  // over for the chain's first steps
  for (int i = tid; i < R; i += kThreads) {
    const bool win = i < W;
    const int page = win ? m.wp[i] : m.fp[i - W];
    int h = 0;
    if (page >= 0) {
      if (page >= P || status[page] != (win ? kInWindow : kInFrozen) ||
          slot_of[page] != (win ? i : i - W))
        __trap();                             // the map's premise fails
      if (win) h = hits[page];
      const int a = m.bucket1(page), b = m.bucket2(page);
      int placed = -1;
      for (int c = 0; c < 8 && placed < 0; ++c) {
        const int slot = (c < 4 ? 4 * a : 4 * b) + (c & 3);
        const int prev = atomicCAS(&m.key[slot], kEmpty, page);
        if (prev == page) __trap();           // a page listed twice
        if (prev == kEmpty) placed = slot;
      }
      if (placed >= 0) {
        m.loc[placed] = (uint16_t)i;
        m.posof[i] = (uint16_t)placed;
      } else {
        const int o = atomicAdd(&counts[4], 1);
        if (o < kOver) over[o] = i;           // else found by a scan
      }
    }
    if (win) m.wh[i] = h;
  }
  __syncthreads();

  // -- the draws: warp 1, NAVIS only ---------------------------------------
  if (POLICY == kNavis && tid >= 32 && tid < 64)
    produce_draws(draws, m.produced, m.consumed, stop, (uint32_t)key[0],
                  (uint32_t)key[1], F, tid & 31);

  // -- the chain: warp 0 ----------------------------------------------------
  if (tid < 32) {
    const int lane = m.lane;
    m.fill = *frozen_fill;
    m.hand = *clock_hand;
    m.clock = *clock;
    m.k1 = (uint32_t)key[0];
    m.k2 = (uint32_t)key[1];
    m.installs = 0;
    // the pages the build left over: listed, or (past kOver) found by a
    // scan of the locations
    const int n_over = counts[4];
    for (int o = 0; o < n_over && o < kOver; ++o) {
      const int i = over[o];
      m.insert(i < W ? m.wp[i] : m.fp[i - W], i, -1);
    }
    if (n_over > kOver)
      for (int i = 0; i < R; ++i) {
        const int page = i < W ? m.wp[i] : m.fp[i - W];
        if (page >= 0 && m.posof[i] == kUnplaced) m.insert(page, i, -1);
      }
    m.head = head;
    m.tail = tail;
    m.n_empty = n_empty;
    int n_hit = 0;
    // the input 32 entries at a time into chunk[0..31], the next 32
    // loaded while these run
    if (traces != nullptr) {
      auto load = [&](int q, int base) {
        return q < Q && base + lane < T ? traces[(long long)q * T + base +
                                                 lane]
                                        : -1;
      };
      int q = 0, base = 0, cur = load(0, 0);
      while (q < Q) {
        const unsigned ends = __ballot_sync(kAll, cur < 0);
        const int n = ends ? __ffs(ends) - 1 : 32;
        int nq = q, nb = base + 32;
        if (ends || nb >= T) {
          nq = q + 1;
          nb = 0;
        }
        const int next = load(nq, nb);
        chunk[lane] = cur;
        __syncwarp();
        int page = chunk[0];
        for (int j = 0; j < n; ++j) {
          const int here = page;
          page = chunk[j + 1 < 32 ? j + 1 : 31];
          n_hit += m.step(here, kAccess);
        }
        __syncwarp();
        cur = next;
        q = nq;
        base = nb;
      }
    } else {
      auto load = [&](int base, int& k) {
        const int i = base + lane;
        k = i < N && kinds != nullptr ? kinds[i] : kind;
        return i < N ? pages[i] : -1;
      };
      int kcur = 0, knext = 0;
      int cur = load(0, kcur);
      for (int base = 0; base < N; base += 32) {
        const int next = load(base + 32, knext);
        // a page past P_max or an unknown kind traps here; each entry
        // packed as page * 4 + kind (-1 a hole; P_max < 2^29, the wrapper
        // checks), one read an operation
        if (__any_sync(kAll, cur >= 0 && ((unsigned)kcur > kPriorityAdmit ||
                                          cur >= m.P)))
          __trap();
        chunk[lane] = cur >= 0 ? cur * 4 + kcur : -1;
        __syncwarp();
        const int n = N - base < 32 ? N - base : 32;
        int next_op = chunk[0];
        for (int j = 0; j < n; ++j) {
          const int op = next_op;
          next_op = chunk[j + 1 < 32 ? j + 1 : 31];
          if (op < 0) continue;
          n_hit += m.step(op >> 2, op & 3);
        }
        __syncwarp();
        cur = next;
        kcur = knext;
      }
    }
    if (lane == 0) {
      *stop = 1;
      *frozen_fill = m.fill;
      *clock_hand = m.hand;
      *clock = m.clock;
      key[0] = (long long)m.k1;
      key[1] = (long long)m.k2;
      hits_out[0] = n_hit;
    }
  }

  // -- epilogue: the region tables back, every thread ----------------------
  __syncthreads();
  for (int i = tid; i < W; i += kThreads) {
    window_pages[i] = m.wp[i];
    window_last[i] = m.wl[i];
  }
  for (int i = tid; i < F; i += kThreads) {
    frozen_pages[i] = m.fp[i];
    frozen_last[i] = m.fl[i];
  }
}

}  // namespace

// Trace rows [Q, T], each up to its first -1.
template <int POLICY>
__global__ void __launch_bounds__(kThreads) cache_replay_kernel(
    int8_t* status, int* hits, int* slot_of, int* window_pages,
    int* window_last, int* frozen_pages, int* frozen_last, int* frozen_fill,
    int* clock_hand, int* clock, long long* key, const int* traces,
    int* hits_out, int Q, int T, int W, int F, int P) {
  run<POLICY>(status, hits, slot_of, window_pages, window_last, frozen_pages,
              frozen_last, frozen_fill, clock_hand, clock, key, traces,
              nullptr, nullptr, hits_out, Q, T, 0, kAccess, W, F, P);
}

// The stream pages [N] with kinds [N] (or `kind` for all where kinds is
// null), skipping -1 pages.
template <int POLICY>
__global__ void __launch_bounds__(kThreads) cache_ops_kernel(
    int8_t* status, int* hits, int* slot_of, int* window_pages,
    int* window_last, int* frozen_pages, int* frozen_last, int* frozen_fill,
    int* clock_hand, int* clock, long long* key, const int* pages,
    const int8_t* kinds, int* hits_out, int N, int kind, int W, int F,
    int P) {
  run<POLICY>(status, hits, slot_of, window_pages, window_last, frozen_pages,
              frozen_last, frozen_fill, clock_hand, clock, key, nullptr,
              pages, kinds, hits_out, 0, 0, N, kind, W, F, P);
}

namespace {

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int POLICY>
int launch(void* const* t, const int* traces, const int* pages,
           const int8_t* kinds, void* hits_out, int Q, int T, int N,
           int kind, int W, int F, int P, void* stream) {
  const size_t smem = Layout(W, F).bytes;
  const auto s = (cudaStream_t)stream;
  cudaError_t err;
  if (traces != nullptr) {
    err = prepare(cache_replay_kernel<POLICY>, smem);
    if (err != cudaSuccess) return (int)err;
    cache_replay_kernel<POLICY><<<1, kThreads, smem, s>>>(
        (int8_t*)t[0], (int*)t[1], (int*)t[2], (int*)t[3], (int*)t[4],
        (int*)t[5], (int*)t[6], (int*)t[7], (int*)t[8], (int*)t[9],
        (long long*)t[10], traces, (int*)hits_out, Q, T, W, F, P);
  } else {
    err = prepare(cache_ops_kernel<POLICY>, smem);
    if (err != cudaSuccess) return (int)err;
    cache_ops_kernel<POLICY><<<1, kThreads, smem, s>>>(
        (int8_t*)t[0], (int*)t[1], (int*)t[2], (int*)t[3], (int*)t[4],
        (int*)t[5], (int*)t[6], (int*)t[7], (int*)t[8], (int*)t[9],
        (long long*)t[10], pages, kinds, (int*)hits_out, N, kind, W, F, P);
  }
  return (int)cudaGetLastError();
}

int dispatch(void* const* t, const int* traces, const int* pages,
             const int8_t* kinds, void* hits_out, int Q, int T, int N,
             int kind, int W, int F, int P, int policy, void* stream) {
  switch (policy) {
    case kNavis:
      return launch<kNavis>(t, traces, pages, kinds, hits_out, Q, T, N, kind,
                            W, F, P, stream);
    case kLru:
      return launch<kLru>(t, traces, pages, kinds, hits_out, Q, T, N, kind, W,
                          F, P, stream);
    case kClock:
      return launch<kClock>(t, traces, pages, kinds, hits_out, Q, T, N, kind,
                            W, F, P, stream);
    case kLfu:
      return launch<kLfu>(t, traces, pages, kinds, hits_out, Q, T, N, kind, W,
                          F, P, stream);
    case kNone:
      return launch<kNone>(t, traces, pages, kinds, hits_out, Q, T, N, kind,
                           W, F, P, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The state's eleven tensors in CacheState's order: status, hits, slot_of,
// window_pages, window_last, frozen_pages, frozen_last, frozen_fill,
// clock_hand, clock, key.
extern "C" int cache_replay_launch(
    void* status, void* hits, void* slot_of, void* window_pages,
    void* window_last, void* frozen_pages, void* frozen_last,
    void* frozen_fill, void* clock_hand, void* clock, void* key,
    const void* traces, void* hits_out, int Q, int T, int W, int F, int P,
    int policy, void* stream) {
  void* const t[11] = {status,       hits,        slot_of,     window_pages,
                       window_last,  frozen_pages, frozen_last, frozen_fill,
                       clock_hand,   clock,        key};
  return dispatch(t, (const int*)traces, nullptr, nullptr, hits_out, Q, T, 0,
                  kAccess, W, F, P, policy, stream);
}

extern "C" int cache_ops_launch(
    void* status, void* hits, void* slot_of, void* window_pages,
    void* window_last, void* frozen_pages, void* frozen_last,
    void* frozen_fill, void* clock_hand, void* clock, void* key,
    const void* pages, const void* kinds, void* hits_out, int N, int kind,
    int W, int F, int P, int policy, void* stream) {
  void* const t[11] = {status,       hits,        slot_of,     window_pages,
                       window_last,  frozen_pages, frozen_last, frozen_fill,
                       clock_hand,   clock,        key};
  return dispatch(t, nullptr, (const int*)pages, (const int8_t*)kinds,
                  hits_out, 0, 0, N, kind, W, F, P, policy, stream);
}
