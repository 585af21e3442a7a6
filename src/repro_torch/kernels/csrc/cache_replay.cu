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
// runs for milliseconds.  Its time is the chain's length times the
// latency of one access: a global-memory read of the page's entries, a
// reduction over the window, a few shuffles.
//
// Design: one warp in one block.  The region tables (window_pages,
// window_last [W], frozen_pages, frozen_last [F]) live in dynamic shared
// memory for the whole run; the page tables (status, hits, slot_of
// [P_max]) stay in device memory and are read and written in place by
// lane 0; the scalars (frozen_fill, clock_hand, clock, the threefry key)
// live in registers, the same in every lane.  The per-access reductions
// run across the warp's 32 lanes: the window's LRU argmin, LFU's argmin of
// hits, CLOCK's sweep from the hand, and the eight eviction probes (one
// lane each, threefry-2x32 bit-exact with jax.random's split and randint).
// Ties go to the first index, as jnp.argmin's.  The trace or op stream is
// read 32 entries at a time, one a lane, and handed out by shuffles.  A
// page id past P_max traps: a read past the tables would corrupt the state
// silently.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNotCached = 0, kInWindow = 1, kInFrozen = 2;
constexpr int kNavis = 0, kClock = 2, kLfu = 3, kNone = 4;  // LRU is 1
constexpr int kAccess = 0, kInvalidate = 1, kPriorityAdmit = 2;
constexpr int kProbes = 8;       // randomized-eviction probe budget
constexpr int kInuseTicks = 64;  // "currently in use" guard
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

// The warp's (value, index) minimum, the first index on ties.
__device__ __forceinline__ void warp_argmin(int& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kAll, v, off);
    const int oi = __shfl_xor_sync(kAll, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

struct Machine {
  int8_t* status;  // [P] device memory
  int* hits;
  int* slot_of;
  int* wp;  // shared: window_pages [W], window_last [W]
  int* wl;
  int* fp;  // shared: frozen_pages [F], frozen_last [F]
  int* fl;
  int P, W, F, policy, lane;
  int fill, hand, clock;  // registers, equal in every lane
  uint32_t k1, k2;

  __device__ void check(int page) const {
    if (page >= P) __trap();
  }

  // First index of the minimum of wl[0, W): the window's LRU victim.
  __device__ int lru_victim() const {
    int v = 0x7fffffff, idx = 0x7fffffff;
    for (int i = lane; i < W; i += 32) {
      if (wl[i] < v) {
        v = wl[i];
        idx = i;
      }
    }
    warp_argmin(v, idx);
    return idx;
  }

  // LFU: the first empty slot, else the first minimum of hits.
  __device__ int lfu_victim() const {
    int v = 0x7fffffff, idx = 0x7fffffff;
    for (int i = lane; i < W; i += 32) {
      const int p = wp[i];
      const int f = p >= 0 ? hits[p] : -1;
      if (f < v) {
        v = f;
        idx = i;
      }
    }
    warp_argmin(v, idx);
    return idx;
  }

  // CLOCK: the first slot from the hand not used in the last 64 ticks;
  // with none, the slot at the hand.
  __device__ int clock_victim() const {
    int best = 0x7fffffff, dummy = 0;
    for (int j = lane; j < W; j += 32) {
      const int idx = (hand + j) % W;
      if (clock - wl[idx] >= kInuseTicks && j < best) best = j;
    }
    warp_argmin(best, dummy);
    return best == 0x7fffffff ? hand % W : (hand + best) % W;
  }

  // Put `page` (a miss) into window slot `victim`, evicting its page.
  __device__ void admit_window(int page, int victim) {
    if (lane == 0) {
      const int old = wp[victim];
      if (old >= 0) {
        status[old] = kNotCached;
        slot_of[old] = -1;
        hits[old] = 0;
      }
      status[page] = kInWindow;
      slot_of[page] = victim;
      hits[page] = 1;
      wp[victim] = page;
      wl[victim] = clock;
    }
    __syncwarp();
  }

  // Move `page` (not frozen) into the frozen region: split the key, draw
  // eight probes with randint(sub, (8,), 0, F), take the first probe of
  // the lowest score (0 empty, 1 not used in the last 64 ticks, 2 else),
  // evict its page and drop `page` from the window if it sits there.
  __device__ void install_frozen(int page) {
    // key, sub = split(key); k_hi, k_lo = split(sub)
    uint32_t a = 0, b = (uint32_t)(lane & 1);
    threefry2x32(k1, k2, a, b);
    const uint32_t nk1 = __shfl_sync(kAll, a, 0);
    const uint32_t nk2 = __shfl_sync(kAll, b, 0);
    const uint32_t s1 = __shfl_sync(kAll, a, 1), s2 = __shfl_sync(kAll, b, 1);
    a = 0;
    b = (uint32_t)(lane & 1);
    threefry2x32(s1, s2, a, b);
    const uint32_t h1 = __shfl_sync(kAll, a, 0), h2 = __shfl_sync(kAll, b, 0);
    const uint32_t l1 = __shfl_sync(kAll, a, 1), l2 = __shfl_sync(kAll, b, 1);
    int score = 0x7fffffff, probe = 0;
    if (lane < kProbes) {
      uint32_t x1 = 0, x2 = (uint32_t)lane, y1 = 0, y2 = (uint32_t)lane;
      threefry2x32(h1, h2, x1, x2);
      threefry2x32(l1, l2, y1, y2);
      const uint32_t higher = x1 ^ x2, lower = y1 ^ y2;
      const uint32_t span = (uint32_t)(F > 1 ? F : 1);
      const uint32_t m16 = 65536u % span;
      const uint32_t mult = (m16 * m16) % span;
      const uint32_t off = ((higher % span) * mult + lower % span) % span;
      probe = (int)off;
      score = fp[probe] < 0 ? 0 : (clock - fl[probe] >= kInuseTicks ? 1 : 2);
    }
    int which = lane;
    warp_argmin(score, which);
    const int victim = __shfl_sync(kAll, probe, which);
    const int old = fp[victim];
    if (lane == 0) {
      if (old >= 0) {
        status[old] = kNotCached;
        slot_of[old] = -1;
      }
      if (status[page] == kInWindow) {
        const int ws = slot_of[page];
        wp[ws] = -1;
        wl[ws] = -1;
      }
      status[page] = kInFrozen;
      slot_of[page] = victim;
      fp[victim] = page;
      fl[victim] = clock;
    }
    fill += old >= 0 ? 0 : 1;
    k1 = nk1;
    k2 = nk2;
    __syncwarp();
  }

  // One access: tick, look up, update.  Returns whether it hit.
  __device__ bool access(int page) {
    check(page);
    clock += 1;
    if (policy == kNone) return false;
    int s = 0, slot = 0, h = 0;
    if (lane == 0) {
      s = status[page];
      slot = slot_of[page];
      h = hits[page];
    }
    s = __shfl_sync(kAll, s, 0);
    slot = __shfl_sync(kAll, slot, 0);
    h = __shfl_sync(kAll, h, 0);
    const bool hit = s != kNotCached;
    if (hit && policy == kNavis) {
      if (s == kInFrozen) {
        if (lane == 0) fl[slot] = clock;
        __syncwarp();
      } else {
        if (lane == 0) {
          hits[page] = h + 1;
          wl[slot] = clock;
        }
        __syncwarp();
        if (h + 1 >= 2) install_frozen(page);
      }
    } else if (hit) {
      if (lane == 0) {
        wl[slot] = clock;
        hits[page] = h + 1;
      }
      __syncwarp();
    } else if (policy == kNavis) {
      admit_window(page, lru_victim());
    } else {
      const int victim = policy == kClock ? clock_victim()
                         : policy == kLfu ? lfu_victim()
                                          : lru_victim();
      admit_window(page, victim);
      if (policy == kClock) hand = (victim + 1) % W;
    }
    return hit;
  }

  // The eviction hint: drop `page` from its region and its tables.
  __device__ void invalidate(int page) {
    check(page);
    if (lane == 0) {
      const int s = status[page];
      if (s != kNotCached) {
        const int slot = slot_of[page];
        if (s == kInWindow) {
          wp[slot] = -1;
          wl[slot] = -1;
        } else {
          fp[slot] = -1;
        }
        status[page] = kNotCached;
        slot_of[page] = -1;
        hits[page] = 0;
      }
    }
    __syncwarp();
  }

  // Straight into the frozen region (NAVIS only); a frozen page only gets
  // its in-use stamp.  No tick.
  __device__ void priority_admit(int page) {
    check(page);
    if (policy != kNavis) return;
    int s = 0, slot = 0;
    if (lane == 0) {
      s = status[page];
      slot = slot_of[page];
    }
    s = __shfl_sync(kAll, s, 0);
    slot = __shfl_sync(kAll, slot, 0);
    if (s == kInFrozen) {
      if (lane == 0) fl[slot] = clock;
      __syncwarp();
    } else {
      install_frozen(page);
    }
  }
};

}  // namespace

// traces != nullptr: replay rows [Q, T], each up to its first -1.
// Otherwise run the stream pages [N] with kinds [N] (or `kind` for all
// where kinds is null), skipping -1 pages.
__global__ void cache_replay_kernel(
    int8_t* status, int* hits, int* slot_of, int* window_pages,
    int* window_last, int* frozen_pages, int* frozen_last, int* frozen_fill,
    int* clock_hand, int* clock, long long* key, const int* traces,
    const int* pages, const int8_t* kinds, int* hits_out, int Q, int T,
    int N, int kind, int W, int F, int P, int policy) {
  extern __shared__ int smem[];
  Machine m;
  m.status = status;
  m.hits = hits;
  m.slot_of = slot_of;
  m.wp = smem;
  m.wl = smem + W;
  m.fp = smem + 2 * W;
  m.fl = smem + 2 * W + F;
  m.P = P;
  m.W = W;
  m.F = F;
  m.policy = policy;
  m.lane = threadIdx.x;
  for (int i = m.lane; i < W; i += 32) {
    m.wp[i] = window_pages[i];
    m.wl[i] = window_last[i];
  }
  for (int i = m.lane; i < F; i += 32) {
    m.fp[i] = frozen_pages[i];
    m.fl[i] = frozen_last[i];
  }
  m.fill = *frozen_fill;
  m.hand = *clock_hand;
  m.clock = *clock;
  m.k1 = (uint32_t)key[0];
  m.k2 = (uint32_t)key[1];
  __syncwarp();

  int n_hit = 0;
  if (traces != nullptr) {
    for (int q = 0; q < Q; ++q) {
      const int* row = traces + (long long)q * T;
      bool more = true;
      for (int base = 0; base < T && more; base += 32) {
        const int mine = base + m.lane < T ? row[base + m.lane] : -1;
        const int n = T - base < 32 ? T - base : 32;
        for (int j = 0; j < n; ++j) {
          const int page = __shfl_sync(kAll, mine, j);
          if (page < 0) {
            more = false;
            break;
          }
          n_hit += m.access(page);
        }
      }
    }
  } else {
    for (int base = 0; base < N; base += 32) {
      const int i = base + m.lane;
      const int mine = i < N ? pages[i] : -1;
      const int kmine = i < N ? (kinds != nullptr ? kinds[i] : kind) : kind;
      const int n = N - base < 32 ? N - base : 32;
      for (int j = 0; j < n; ++j) {
        const int page = __shfl_sync(kAll, mine, j);
        const int k = __shfl_sync(kAll, kmine, j);
        if (page < 0) continue;
        if (k == kAccess) {
          n_hit += m.access(page);
        } else if (k == kInvalidate) {
          m.invalidate(page);
        } else if (k == kPriorityAdmit) {
          m.priority_admit(page);
        } else {
          __trap();
        }
      }
    }
  }

  __syncwarp();
  for (int i = m.lane; i < W; i += 32) {
    window_pages[i] = m.wp[i];
    window_last[i] = m.wl[i];
  }
  for (int i = m.lane; i < F; i += 32) {
    frozen_pages[i] = m.fp[i];
    frozen_last[i] = m.fl[i];
  }
  if (m.lane == 0) {
    *frozen_fill = m.fill;
    *clock_hand = m.hand;
    *clock = m.clock;
    key[0] = (long long)m.k1;
    key[1] = (long long)m.k2;
    hits_out[0] = n_hit;
  }
}

namespace {

int launch(void* const* t, const int* traces, const int* pages,
           const int8_t* kinds, void* hits_out, int Q, int T, int N,
           int kind, int W, int F, int P, int policy, void* stream) {
  const size_t smem = (size_t)2 * (W + F) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cache_replay_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(
      (int8_t*)t[0], (int*)t[1], (int*)t[2], (int*)t[3], (int*)t[4],
      (int*)t[5], (int*)t[6], (int*)t[7], (int*)t[8], (int*)t[9],
      (long long*)t[10], traces, pages, kinds, (int*)hits_out, Q, T, N, kind,
      W, F, P, policy);
  return (int)cudaGetLastError();
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
  return launch(t, (const int*)traces, nullptr, nullptr, hits_out, Q, T, 0,
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
  return launch(t, nullptr, (const int*)pages, (const int8_t*)kinds,
                hits_out, 0, 0, N, kind, W, F, P, policy, stream);
}
