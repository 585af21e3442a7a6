// pool_merge: keep the P smallest of each lane's  pool [P] ∪ new [Q],
// ascending and stable on ties by concatenation position.
//
// Replaces the TPU kernel `_merge_kernel` / `pool_merge_pallas`
// (src/repro/kernels/topk_pool.py), which ranks every element with a dense
// [L, L] compare on the VPU and scatters by rank.
//
// What bounds it on an H100: per lane it reads L = P + Q (distance, id)
// pairs and writes P pairs, a few KiB, so the byte bound is tiny; a rank
// by L x L compares (232^2 = 54k a lane at the traversal's (40, 192)) made
// the first version issue-bound at 33x that bound.
//
// Design: one CTA per lane sorts L unique 64-bit keys (order_key.cuh: the
// order-preserving bits of d over the element's concatenation position).
// The keys are unique, so their ascending order is exactly the stable
// argsort of d: no precondition on either input's order.  The keys, padded
// to N = 2^n >= L (at least 32) with all-ones keys, run through a bitonic
// network, N log2 N (log2 N + 1) / 4 compare-exchanges (4,608 at N = 256),
// one key per thread: strides below 32 exchange through warp shuffles,
// larger strides through a double-buffered shared array (one barrier a
// stage: 6 of the 36 stages at N = 256).  The lane's distances and ids wait
// in shared memory; the first P keys give each output slot its position,
// and d and id are read back through it (d keeps its sign).  One key a
// thread keeps the chain of dependent steps short: with one warp a lane
// and eight keys a thread, a wave of 256 lanes leaves two warps on an SM
// to run a serial network.
#include <cuda_runtime.h>

#include "order_key.cuh"

__global__ void pool_merge_kernel(const float* __restrict__ pool_d,
                                  const int* __restrict__ pool_ids,
                                  const float* __restrict__ new_d,
                                  const int* __restrict__ new_ids,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_ids, int P, int Q) {
  extern __shared__ u64 smem[];
  const int N = blockDim.x, t = threadIdx.x, L = P + Q;
  float* sd = reinterpret_cast<float*>(smem + 2 * N);
  int* sid = reinterpret_cast<int*>(sd + L);
  const long long b = blockIdx.x;
  u64 v = ~0ull;
  if (t < L) {
    const float d = t < P ? pool_d[b * P + t] : new_d[b * Q + t - P];
    sd[t] = d;
    sid[t] = t < P ? pool_ids[b * P + t] : new_ids[b * Q + t - P];
    v = order_key(d, t);
  }
  __syncthreads();
  int stage = 0;
  for (int k = 2; k <= N; k <<= 1) {
    const bool up = (t & k) == 0;
    for (int j = k >> 1; j > 0; j >>= 1) {
      u64 p;
      if (j < 32) {
        p = __shfl_xor_sync(0xffffffffu, v, j);
      } else {
        u64* x = smem + (stage++ & 1) * N;  // two buffers, by stage
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
                                 void* out_d, void* out_ids, int B, int P,
                                 int Q, void* stream) {
  const int L = P + Q;
  if (L > 1024) return (int)cudaErrorInvalidValue;
  int n = 32;
  while (n < L) n <<= 1;
  const size_t smem = 2 * n * sizeof(u64) + L * (sizeof(float) + sizeof(int));
  pool_merge_kernel<<<B, n, smem, (cudaStream_t)stream>>>(
      (const float*)pool_d, (const int*)pool_ids, (const float*)new_d,
      (const int*)new_ids, (float*)out_d, (int*)out_ids, P, Q);
  return (int)cudaGetLastError();
}
