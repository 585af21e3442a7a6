// pool_merge: keep the P smallest of each lane's  pool [P] ∪ new [Q],
// ascending and stable on ties by concatenation position.
//
// Replaces the TPU kernel `_merge_kernel` / `pool_merge_pallas`
// (src/repro/kernels/topk_pool.py), which ranks every element with a dense
// [L, L] compare on the VPU and scatters by rank.
//
// What bounds it on an H100: per lane it reads L = P + Q (distance, id)
// pairs and writes P pairs, a few KiB, so the byte bound is tiny (0.17 µs
// for a wave of 256 at the traversal's (40, 192)); a launch and one round
// trip to device memory take most of what the card needs.  The earlier
// design sorted all L keys through a bitonic network, one key a thread
// (36 dependent stages, 6 of them block-wide barriers at L = 232), though
// only P of them are kept (40 of 232 on a hop, 10 of 1,024 in
// FreshDiskANN's buffer merge).
//
// Design: one CTA a lane, one thread a key (order_key.cuh's unique 64-bit
// keys: distance bits over concatenation position, so ascending keys are
// the stable argsort of d and the result does not depend on the route).
// One __syncthreads_or over adjacent pool keys (the next by shuffle; a
// warp's last thread reads it from device memory) picks the route:
// - sorted pool (every caller: the pool is the previous merge's output or
//   a stable sort's): only a new key below the pool's largest can enter,
//   and these survivors are compacted by warp ballots.  Each survivor's
//   place is the survivors below it (counted over the compacted keys,
//   read as shared-memory broadcasts) plus the pool keys below it (a
//   binary search); each pool key's is its index plus the survivors below
//   it: the first P of the merge of two sorted runs, by co-rank, with no
//   sort and three barriers.  Survivors are few once a search's pool
//   holds real distances, and all of a lane's threads share the counting
//   when they are many.
// - unsorted pool, or a sorted one with so many survivors that counting
//   (n (n + P) compares) would cost more than the network (~N log2(N)^2
//   / 4 compare-exchanges; past 3 N log2(N)^2 compares, as measured): the
//   earlier design's network over all L keys (strides under 32 by warp
//   shuffles, larger ones through two shared buffers).
// The route a lane took is counted where the caller asks (`routes`:
// sorted by counting, sorted through the network, unsorted), which is how
// chip_smoke.py shows all three launched.
// One warp a lane (several lanes a CTA, no block-wide barrier) was tried
// first, ranking survivors in registers: exact, but slower than the
// network at the hop's (40, 192), as a single warp runs the whole chain of
// dependent steps (PERF.md §6).  What this design costs: a pool that still
// ends in padding (a search's first hops) lets ~150 of 192 new keys
// survive, and counting them is a little slower than the network; the
// unsorted route pays the sortedness test on top of the network.
#include <cuda_runtime.h>

#include "order_key.cuh"

constexpr unsigned kFull = 0xffffffffu;

// How many of the ascending a[0 .. n) lie below x.
__device__ __forceinline__ int count_below(const u64* a, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One CTA a lane, one thread a key: thread t holds element t of pool ++
// new (N = blockDim.x, a power of two >= L, at least 32).
__global__ void pool_merge_kernel(const float* __restrict__ pool_d,
                                  const int* __restrict__ pool_ids,
                                  const float* __restrict__ new_d,
                                  const int* __restrict__ new_ids,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_ids,
                                  unsigned long long* __restrict__ routes,
                                  int P, int Q) {
  extern __shared__ u64 smem[];
  const int N = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int L = P + Q;
  u64* keys = smem;              // [N] by position, all-ones past L
  u64* set = smem + N;           // [N] survivors, or the network's buffer
  float* sd = reinterpret_cast<float*>(set + N);  // [L] by position
  int* sid = reinterpret_cast<int*>(sd + L);      // [L] by position
  int* warp_n = sid + L;                          // [32] survivors a warp
  const long long b = blockIdx.x;
  float d = 0.0f;
  int id = -1;
  u64 key = ~0ull;
  // the pool is sorted when each of its keys lies below the next: the next
  // comes by shuffle, or for a warp's last thread from device memory
  const bool has_next = t + 1 < P;
  float d_next = 0.0f;
  if (t < L) {
    const bool in_pool = t < P;
    d = in_pool ? pool_d[b * P + t] : new_d[b * Q + t - P];
    id = in_pool ? pool_ids[b * P + t] : new_ids[b * Q + t - P];
    if (lane == 31 && has_next) d_next = pool_d[b * P + t + 1];
    key = order_key(d, t);
    sd[t] = d;
    sid[t] = id;
  }
  keys[t] = key;
  const u64 down = __shfl_down_sync(kFull, key, 1);
  const u64 next = lane == 31 ? order_key(d_next, t + 1) : down;
  const bool unsorted = __syncthreads_or(has_next && key > next);
  if (!unsorted) {
    // a new key below the pool's largest survives (a larger one ranks past
    // P); survivors are compacted in position order
    const u64 top = keys[P - 1];
    const bool survives = t >= P && t < L && key < top;
    const unsigned mask = __ballot_sync(kFull, survives);
    if (lane == 0) warp_n[warp] = __popc(mask);
    __syncthreads();
    int before = 0, n = 0;
    for (int w = 0; w < (N >> 5); ++w) {
      const int c = warp_n[w];
      before += w < warp ? c : 0;
      n += c;
    }
    // counting takes n (n + P) compares, the network ~N log2(N)^2 / 4
    // compare-exchanges and log2 N barriers: with more survivors than
    // that pays for (3 N log2(N)^2 compares, as measured on an H100), the
    // sorted pool goes through the network too
    const int lg = 31 - __clz(N);
    const bool count = (long long)n * (n + P) <= 3ll * N * lg * lg;
    if (routes != nullptr && t == 0) atomicAdd(routes + (count ? 0 : 1), 1ull);
    if (count) {
      if (survives) set[before + __popc(mask & ((1u << lane) - 1u))] = key;
      __syncthreads();
      if (survives || t < P) {
        // a pool key's place: its index and the survivors below it; a
        // survivor's: the survivors and the pool keys below it
        int below = 0;
#pragma unroll 8
        for (int j = 0; j < n; ++j) below += set[j] < key;
        const int place = survives ? below + count_below(keys, P, key)
                                   : t + below;
        if (place < P) {
          out_d[b * P + place] = d;
          out_ids[b * P + place] = id;
        }
      }
      return;
    }
  } else if (routes != nullptr && t == 0) {
    atomicAdd(routes + 2, 1ull);
  }
  // an unsorted pool, or too many survivors: every key through a bitonic
  // network, one key a thread; strides under 32 exchange through warp
  // shuffles, larger ones through the two shared buffers (one barrier a
  // stage)
  u64 v = key;
  int stage = 0;
  for (int k = 2; k <= N; k <<= 1) {
    const bool up = (t & k) == 0;
    for (int j = k >> 1; j > 0; j >>= 1) {
      u64 p;
      if (j < 32) {
        p = __shfl_xor_sync(kFull, v, j);
      } else {
        u64* x = (stage++ & 1) ? set : keys;
        x[t] = v;
        __syncthreads();
        p = x[t ^ j];
      }
      const bool lower = (t & j) == 0;
      v = (lower == up) ? (v < p ? v : p) : (v > p ? v : p);
    }
  }
  if (t < P) {
    const int pos = key_pos(v);
    out_d[b * P + t] = sd[pos];
    out_ids[b * P + t] = sid[pos];
  }
}

extern "C" int pool_merge_launch(const void* pool_d, const void* pool_ids,
                                 const void* new_d, const void* new_ids,
                                 void* out_d, void* out_ids, void* routes,
                                 int B, int P, int Q, void* stream) {
  const int L = P + Q;
  if (L > 1024 || P < 1 || Q < 0) return (int)cudaErrorInvalidValue;
  int n = 32;
  while (n < L) n <<= 1;
  const size_t smem = 2 * n * sizeof(u64) +
                      L * (sizeof(float) + sizeof(int)) + 32 * sizeof(int);
  pool_merge_kernel<<<B, n, smem, (cudaStream_t)stream>>>(
      (const float*)pool_d, (const int*)pool_ids, (const float*)new_d,
      (const int*)new_ids, (float*)out_d, (int*)out_ids,
      (unsigned long long*)routes, P, Q);
  return (int)cudaGetLastError();
}
