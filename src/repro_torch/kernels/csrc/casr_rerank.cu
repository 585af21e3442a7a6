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
// counts the rows these inputs load.
//
// Design: the lane's pool ids, exact distances, loaded flags and top-K
// state live in shared memory, and q is staged there once.  Loader warps
// take the group's rows and gather each by id straight from `vectors`
// (16-byte loads, the shared difference-form body in l2_row.cuh): no
// [B, S, D] copy and no second read of it.  The last warp merges: in round
// g, while the loaders fetch group g, it merges group g - 1 into the
// running top-K (incremental: a position outside the top-K over groups < g
// can never re-enter it, and keys from order_key.cuh make the merge's
// ranks unique and stable), compares the ids with the previous round's,
// and sets the lane's done flag.  One __syncthreads per round; no host
// sync and no launch per round.
#include <cuda_runtime.h>

#include "l2_row.cuh"
#include "order_key.cuh"

constexpr float kInf = 3.4e38f;
constexpr int kMaxLoaderWarps = 8;

struct LaneState {
  const int* ids;   // [P] pool ids
  float* ed;        // [P] exact distances (INF where not loaded)
  int* ld;          // [P] loaded flags
  u64* gkeys;       // [S] keys of the group being merged
  int* prev;        // [K] previous round's top-K ids
  int P, S, K;
};

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
    const unsigned m = __ballot_sync(0xffffffffu, take);
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
    int q_bytes) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* sq = reinterpret_cast<float*>(base);
  u64* list_a = reinterpret_cast<u64*>(base + q_bytes);
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
  const int n_loaders = blockDim.x / 32 - 1;
  const int G = (P + S - 1) / S;
  for (int i = tid; i < D; i += blockDim.x) sq[i] = q[b * D + i];
  for (int i = tid; i < P; i += blockDim.x) {
    ids[i] = pool_ids[b * P + i];
    st.ed[i] = kInf;
    st.ld[i] = 0;
  }
  for (int i = tid; i < K; i += blockDim.x) st.prev[i] = -1;
  __syncthreads();

  auto load_group = [&](int g) {
    const int hi = min(g * S + S, P);
    for (int r = g * S + warp; r < hi; r += n_loaders) {
      const int id = ids[r];
      if (id < 0) continue;
      if (id >= N) __trap();
      const float d = row_sqdist(vectors + (size_t)id * D, sq, D, lane);
      if (lane == 0) {
        st.ed[r] = d;
        st.ld[r] = 1;
      }
    }
  };

  // pipeline start: group 0 is loaded before the loop (Alg 1 line 3)
  if (warp < n_loaders) load_group(0);
  __syncthreads();
  u64* cur = list_a;
  u64* nxt = list_b;
  int c = 0;  // entries of the running top-K (merge warp only)
  int g = 1, rounds = 1;
  for (;;) {
    if (warp < n_loaders) {
      if (g < G) load_group(g);  // speculative next-group I/O
    } else {
      c = merge_group(st, g - 1, cur, nxt, c, lane);
      u64* t = cur;
      cur = nxt;
      nxt = t;
      bool same = true, any_prev = false;
      for (int slot = lane; slot < K; slot += 32) {
        const int id = slot < c ? ids[key_pos(cur[slot])] : -1;
        same &= id == st.prev[slot];
        any_prev |= st.prev[slot] >= 0;
        st.prev[slot] = id;
      }
      same = __all_sync(0xffffffffu, same);
      any_prev = __any_sync(0xffffffffu, any_prev);
      if (lane == 0) done[g & 1] = (same && any_prev) || g >= G;
    }
    __syncthreads();
    ++rounds;
    if (done[g & 1]) break;
    ++g;
  }

  if (warp == n_loaders) {
    // the final top-K also takes the group loaded in the last round
    if (g < G) {
      c = merge_group(st, g, cur, nxt, c, lane);
      cur = nxt;
    }
    for (int slot = lane; slot < K; slot += 32) {
      const int pos = slot < c ? key_pos(cur[slot]) : -1;
      topk_ids[b * K + slot] = pos >= 0 ? ids[pos] : -1;
      topk_d[b * K + slot] = pos >= 0 ? st.ed[pos] : kInf;
    }
    int cnt = 0;
    for (int i = lane; i < P; i += 32) cnt += st.ld[i];
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) {
      n_loaded[b] = cnt;
      rounds_out[b] = rounds;
    }
  }
  for (int i = tid; i < P; i += blockDim.x) {
    exact_d[b * P + i] = st.ed[i];
    loaded[b * P + i] = (unsigned char)st.ld[i];
  }
}

extern "C" int casr_rerank_launch(const void* q, const void* vectors,
                                  const void* pool_ids, void* exact_d,
                                  void* loaded, void* topk_ids, void* topk_d,
                                  void* n_loaded, void* rounds, int B, int P,
                                  int D, int N, int K, int S, void* stream) {
  const int q_bytes = ((D * (int)sizeof(float) + 15) / 16) * 16;
  const size_t smem = (size_t)q_bytes + sizeof(u64) * (2 * K + S) +
                      sizeof(int) * (3 * P + K + 2);
  if (smem > 48 * 1024 || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int loaders = S < kMaxLoaderWarps ? S : kMaxLoaderWarps;
  casr_rerank_kernel<<<B, 32 * (loaders + 1), smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)vectors, (const int*)pool_ids,
      (float*)exact_d, (unsigned char*)loaded, (int*)topk_ids,
      (float*)topk_d, (long long*)n_loaded, (int*)rounds, P, D, N, K, S,
      q_bytes);
  return (int)cudaGetLastError();
}
