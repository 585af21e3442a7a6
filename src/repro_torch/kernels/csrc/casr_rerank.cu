// casr_rerank: the whole CASR group loop (Algorithm 1) of a wave in one
// launch, one CTA per lane.
//
// Replaces, on the main path, the TPU kernel `_rerank_kernel` /
// `rerank_l2_pallas` (src/repro/kernels/rerank_l2.py) together with the
// loop around it in `casr_rerank` (src/repro/core/casr.py), which gathers a
// group's rows, reranks them, and runs the stable top-k merge of
// `pool_merge_pallas` (src/repro/kernels/topk_pool.py) once per round.
//
// What it computes, per lane (exactly what the reference's
// `casr_rerank_many` returns for that lane): over the PQ-sorted pool
// (-1 tail), groups of S positions are loaded in order; group 0 before the
// loop, group g in round g while g < G = ceil(P / S) (speculative I/O).
// Round g takes the stable top-K over the loaded positions < g * S; the lane
// stops when that top-K's ids equal the previous round's and the previous
// top-K held a valid id, or when g = G.  The final top-K is over everything
// loaded; ties go to the lower pool position.
//
// What bounds it on an H100: device-memory bytes.  It must read the rows it
// loads (D * 4 bytes each: 3 KiB at D = 768), the query and the pool ids,
// and write P distances and flags and the top-K per lane; the rank work is
// K + S keys a round.  The loop's length depends on the data, so the bound
// counts the rows these inputs load.  What held the first design back was
// not bandwidth but the chain of rounds: each round fetched its group from
// device memory and waited for it before the round's one barrier, so a
// lane paid one round trip a group (G = 10 at P 40 / s 4), one group in
// flight at a time, and the merge warp's shared-memory list added its own
// chain of dependent reads to every round.
//
// Design: the lane's pool ids, exact distances, loaded flags and top-K
// state live in shared memory, and q is staged there once.  The card's
// reads are split from CASR's loads: a producer warp issues each group's
// rows as 1-D bulk copies (`cp.async.bulk`, one a row, completing on the
// stage's mbarrier) into a ring of `stages` groups in shared memory,
// `stages - 1` = kPrefetch groups ahead of the round that consumes them
// (fewer where they do not fit), and the loader warps wait on the stage
// and take each row's distance from shared memory with the float4 body
// of l2_row.cuh (row_sqdist_shared: the same sums as rerank_l2_rows').  A group prefetched past the round where the
// lane stops is read and not loaded: `loaded`, `n_loaded` and the outputs
// are CASR's, at most (stages - 1) S rows a lane more are read, and the
// producer waits for those copies before the lane exits.  Where two
// stages of S rows do not fit the 227 KB a block may use (S 8 at D
// 8,192), D % 4 != 0 or the rows are not 16-byte aligned, the same kernel
// runs with stages = 0 and no producer, and its loaders read the rows
// straight from device memory, one group a round (row_sqdist: again the
// same sums).  The merge warp, in round g, while the loaders take group
// g, folds group g - 1 into the running top-K (incremental: a position
// outside the top-K over groups < g can never re-enter it, and keys from
// order_key.cuh make the ranks unique and stable), compares the ids with
// the previous round's and sets the lane's done flag.  For K <= 32 the
// top-K lives in its registers, one key a lane, and a key goes in by a
// ballot (its rank) and one shuffle up, so a round's merge reads shared
// memory only for the group's distances and the ids; a larger K keeps
// the list in shared memory (merge_group).  One __syncthreads per round;
// no host sync and no launch per round.
#include <cuda_runtime.h>

#include "l2_row.cuh"
#include "order_key.cuh"

constexpr float kInf = 3.4e38f;
constexpr int kMaxLoaderWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;   // the 227 KB a block may use
constexpr int kMaxDevices = 64;
// Groups the ring holds past the one a round consumes.  Of 0-3, 1 was the
// fastest or within 1% of it at P 40 / s 4 and P 64 / s 8 on an H100
// (PERF.md §6: one build of this file a depth, timed side by side); each
// group more reads up to S rows a lane that CASR may never load.
constexpr int kPrefetch = 1;

struct LaneState {
  const int* ids;   // [P] pool ids
  float* ed;        // [P] exact distances (INF where not loaded)
  int* ld;          // [P] loaded flags
  u64* gkeys;       // [S] keys of the group being merged
  int* prev;        // [K] previous round's top-K ids
  int P, S, K;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive once and expect `bytes` of copies on the stage's barrier
__device__ __forceinline__ void bar_expect(u64* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a
// copy that never lands (a fault) traps after ~2^32 cycles instead of
// hanging the card
__device__ __forceinline__ void bar_wait(u64* bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 32))
      __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Merge warp: fold the loaded positions of group g into the sorted top-K
// `cur` (c entries), writing the result to `nxt`; returns the new count.
__device__ int merge_group(const LaneState& st, int g, const u64* cur,
                           u64* nxt, int c, int lane) {
  const int lo = g * st.S;
  const int hi = min(lo + st.S, st.P);
  int n_g = 0;
  for (int base = lo; base < hi; base += 32) {
    const int r = base + lane;
    const bool take = r < hi && st.ld[r];
    const unsigned m = __ballot_sync(kFull, take);
    if (take)
      st.gkeys[n_g + __popc(m & ((1u << lane) - 1u))] =
          order_key(st.ed[r], r);
    n_g += __popc(m);
  }
  __syncwarp();
  // ranks in the union: group positions all come after the list's, so a
  // list key's rank is its index plus the group keys below it
  for (int a = lane; a < c; a += 32) {
    const u64 key = cur[a];
    int rank = a;
    for (int x = 0; x < n_g; ++x) rank += st.gkeys[x] < key;
    if (rank < st.K) nxt[rank] = key;
  }
  for (int x = lane; x < n_g; x += 32) {
    const u64 key = st.gkeys[x];
    int rank = 0;
    for (int a = 0; a < c; ++a) rank += cur[a] < key;
    for (int y = 0; y < n_g; ++y) rank += st.gkeys[y] < key;
    if (rank < st.K) nxt[rank] = key;
  }
  __syncwarp();
  return min(c + n_g, st.K);
}

__global__ void casr_rerank_kernel(
    const float* __restrict__ q, const float* __restrict__ vectors,
    const int* __restrict__ pool_ids, float* __restrict__ exact_d,
    unsigned char* __restrict__ loaded, int* __restrict__ topk_ids,
    float* __restrict__ topk_d, long long* __restrict__ n_loaded,
    int* __restrict__ rounds_out, int P, int D, int N, int K, int S,
    int q_bytes, int stages) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* sq = reinterpret_cast<float*>(base);
  float* ring = reinterpret_cast<float*>(base + q_bytes);  // [stages][S][D]
  u64* bars = reinterpret_cast<u64*>(ring + (size_t)stages * S * D);
  u64* list_a = bars + stages;
  u64* list_b = list_a + K;
  LaneState st;
  st.gkeys = list_b + K;
  st.ed = reinterpret_cast<float*>(st.gkeys + S);
  int* ids = reinterpret_cast<int*>(st.ed + P);
  st.ids = ids;
  st.ld = ids + P;
  st.prev = st.ld + P;
  int* done = st.prev + K;  // [2], by round parity
  st.P = P;
  st.S = S;
  st.K = K;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_loaders = min(S, kMaxLoaderWarps);
  const int merger = n_loaders, producer = n_loaders + 1;
  const int G = (P + S - 1) / S;
  const uint32_t row_bytes = (uint32_t)D * sizeof(float);
  if (tid == 0 && stages > 0) {
    for (int s = 0; s < stages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < D; i += blockDim.x) sq[i] = q[b * D + i];
  for (int i = tid; i < P; i += blockDim.x) {
    ids[i] = pool_ids[b * P + i];
    st.ed[i] = kInf;
    st.ld[i] = 0;
  }
  for (int i = tid; i < K; i += blockDim.x) st.prev[i] = -1;
  __syncthreads();

  // producer warp: issue group g's rows into stage g % stages (ids past
  // the store are not read here: the loaders trap on them if CASR loads
  // them)
  auto issue = [&](int g) {
    if (g >= G) return;
    const int lo = g * S, hi = min(lo + S, P);
    u64* bar = bars + g % stages;
    float* stage = ring + (size_t)(g % stages) * S * D;
    int rows = 0;
    for (int r0 = lo; r0 < hi; r0 += 32) {
      const int r = r0 + lane;
      const int id = r < hi ? ids[r] : -1;
      rows += __popc(__ballot_sync(kFull, id >= 0 && id < N));
    }
    if (lane == 0) bar_expect(bar, rows * row_bytes);
    __syncwarp();
    for (int r = lo + lane; r < hi; r += 32) {
      const int id = ids[r];
      if (id >= 0 && id < N)
        bulk_copy(stage + (size_t)(r - lo) * D, vectors + (size_t)id * D,
                  row_bytes, bar);
    }
  };

  // loader warps: CASR's load of group g, from the ring or from device
  // memory
  auto load_group = [&](int g) {
    const int lo = g * S, hi = min(lo + S, P);
    const float* stage = nullptr;
    if (stages > 0) {
      bar_wait(bars + g % stages, (uint32_t)(g / stages) & 1u);
      stage = ring + (size_t)(g % stages) * S * D;
    }
    for (int r = lo + warp; r < hi; r += n_loaders) {
      const int id = ids[r];
      if (id < 0) continue;
      if (id >= N) __trap();
      const float d =
          stage != nullptr
              ? row_sqdist_shared(stage + (size_t)(r - lo) * D, sq, D, lane)
              : row_sqdist(vectors + (size_t)id * D, sq, D, lane);
      if (lane == 0) {
        st.ed[r] = d;
        st.ld[r] = 1;
      }
    }
  };

  // The merge warp's running top-K for K <= 32: lane i holds its i-th key
  // (all-ones past the count) and the previous round's i-th id, and each
  // loaded key of a group is inserted by its rank (a ballot) with one
  // shuffle up; for K > 32 the list lives in shared memory (merge_group).
  const bool in_regs = K <= 32;
  u64 lk = ~0ull;
  int prev_id = -1;
  auto insert_group = [&](int g) {
    const int lo = g * S, hi = min(lo + S, P);
    for (int r0 = lo; r0 < hi; r0 += 32) {
      const int r = r0 + lane;
      const bool take = r < hi && st.ld[r];
      const u64 x = take ? order_key(st.ed[r], r) : ~0ull;
      for (unsigned m = __ballot_sync(kFull, take); m != 0; m &= m - 1) {
        const u64 key = __shfl_sync(kFull, x, __ffs(m) - 1);
        const int rank = __popc(__ballot_sync(kFull, lk < key));
        const u64 below = __shfl_up_sync(kFull, lk, 1);
        if (lane == rank)
          lk = key;
        else if (lane > rank)
          lk = below;
        if (lane >= K) lk = ~0ull;
      }
    }
  };

  // pipeline start: groups 0 .. stages - 1 in flight, group 0 loaded
  // before the loop (Alg 1 line 3)
  if (stages > 0 && warp == producer)
    for (int g = 0; g < stages; ++g) issue(g);
  if (warp < n_loaders) load_group(0);
  __syncthreads();
  u64* cur = list_a;
  u64* nxt = list_b;
  int c = 0;  // entries of the running top-K (merge warp only)
  int g = 1, rounds = 1;
  for (;;) {
    if (warp < n_loaders) {
      if (g < G) load_group(g);  // speculative next-group I/O
    } else if (warp == producer) {
      // group g - 1's stage is free after the last barrier: refill it
      issue(g + stages - 1);
    } else {
      bool same = true, any_prev = false;
      if (in_regs) {
        insert_group(g - 1);
        const int id = lane < K && lk != ~0ull ? ids[key_pos(lk)] : -1;
        same = lane >= K || id == prev_id;
        any_prev = lane < K && prev_id >= 0;
        prev_id = id;
      } else {
        c = merge_group(st, g - 1, cur, nxt, c, lane);
        u64* t = cur;
        cur = nxt;
        nxt = t;
        for (int slot = lane; slot < K; slot += 32) {
          const int id = slot < c ? ids[key_pos(cur[slot])] : -1;
          same &= id == st.prev[slot];
          any_prev |= st.prev[slot] >= 0;
          st.prev[slot] = id;
        }
      }
      same = __all_sync(kFull, same);
      any_prev = __any_sync(kFull, any_prev);
      if (lane == 0) done[g & 1] = (same && any_prev) || g >= G;
    }
    __syncthreads();
    ++rounds;
    if (done[g & 1]) break;
    ++g;
  }

  if (warp == merger) {
    // the final top-K also takes the group loaded in the last round
    if (in_regs) {
      if (g < G) insert_group(g);
      const int pos = lane < K && lk != ~0ull ? key_pos(lk) : -1;
      if (lane < K) {
        topk_ids[b * K + lane] = pos >= 0 ? ids[pos] : -1;
        topk_d[b * K + lane] = pos >= 0 ? st.ed[pos] : kInf;
      }
    } else {
      if (g < G) {
        c = merge_group(st, g, cur, nxt, c, lane);
        cur = nxt;
      }
      for (int slot = lane; slot < K; slot += 32) {
        const int pos = slot < c ? key_pos(cur[slot]) : -1;
        topk_ids[b * K + slot] = pos >= 0 ? ids[pos] : -1;
        topk_d[b * K + slot] = pos >= 0 ? st.ed[pos] : kInf;
      }
    }
    int cnt = 0;
    for (int i = lane; i < P; i += 32) cnt += st.ld[i];
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
      n_loaded[b] = cnt;
      rounds_out[b] = rounds;
    }
  }
  for (int i = tid; i < P; i += blockDim.x) {
    exact_d[b * P + i] = st.ed[i];
    loaded[b * P + i] = (unsigned char)st.ld[i];
  }
  if (stages > 0 && warp == producer) {
    // the shared memory must outlive the copies still in flight: groups
    // issued past the last one loaded
    const int last_loaded = min(g, G - 1);
    const int last_issued = min(g + stages - 1, G - 1);
    for (int h = last_loaded + 1; h <= last_issued; ++h)
      bar_wait(bars + h % stages, (uint32_t)(h / stages) & 1u);
  }
}

static size_t fixed_smem(int q_bytes, int P, int K, int S, int stages) {
  return (size_t)q_bytes + sizeof(u64) * (stages + 2 * K + S) +
         sizeof(int) * (3 * P + K + 2);
}

// The ring's stages for these shapes: kPrefetch + 1 where they fit, fewer
// where not, 0 (rows read straight from device memory) where two stages do
// not fit, D % 4 != 0 or the rows are not 16-byte aligned.
extern "C" int casr_rerank_stages(const void* vectors, int P, int D, int K,
                                  int S) {
  if (D % 4 != 0 || ((uintptr_t)vectors & 15) != 0) return 0;
  const int q_bytes = ((D * (int)sizeof(float) + 15) / 16) * 16;
  const size_t stage = (size_t)S * D * sizeof(float);
  for (int n = kPrefetch + 1; n >= 2; --n)
    if (fixed_smem(q_bytes, P, K, S, n) + n * stage <= (size_t)kSmemMax)
      return n;
  return 0;
}

extern "C" int casr_rerank_launch(const void* q, const void* vectors,
                                  const void* pool_ids, void* exact_d,
                                  void* loaded, void* topk_ids, void* topk_d,
                                  void* n_loaded, void* rounds, int B, int P,
                                  int D, int N, int K, int S, void* stream) {
  if (S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int q_bytes = ((D * (int)sizeof(float) + 15) / 16) * 16;
  const int stages = casr_rerank_stages(vectors, P, D, K, S);
  const size_t smem = fixed_smem(q_bytes, P, K, S, stages) +
                      (size_t)stages * S * D * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // The opt-in past 48 KB is set once per device, to the most a block may
  // use
  static bool opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && !opted_in[dev]) {
    err = cudaFuncSetAttribute(casr_rerank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  // loader warps, the merge warp and, with a ring, the producer warp
  const int warps = (S < kMaxLoaderWarps ? S : kMaxLoaderWarps) + 1 +
                    (stages > 0 ? 1 : 0);
  casr_rerank_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)vectors, (const int*)pool_ids,
      (float*)exact_d, (unsigned char*)loaded, (int*)topk_ids,
      (float*)topk_d, (long long*)n_loaded, (int*)rounds, P, D, N, K, S,
      q_bytes, stages);
  return (int)cudaGetLastError();
}
