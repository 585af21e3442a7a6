// pool_merge: keep the P smallest of each lane's  pool [P] ∪ new [Q].
//
// Replaces the TPU kernel `_merge_kernel` / `pool_merge_pallas`
// (src/repro/kernels/topk_pool.py), which ranks every element with a dense
// [L, L] compare on the VPU and scatters by rank.
//
// What bounds it on an H100: per lane it reads L = P + Q (distance, id)
// pairs and writes P pairs, a few KiB, so bytes are small; the rank pass is
// L*L compares per lane (232^2 ≈ 54k at the traversal's (40, 192)), read
// from shared memory.  At a wave of a few hundred lanes the card is bound
// by latency and shared-memory bandwidth, not by device memory.
//
// Design: one CTA per lane, the concatenation held in shared memory.
// Thread i counts rank_i = #{j : d_j < d_i or (d_j == d_i and j < i)} and
// writes slot rank_i when it is < P.  The ranks are a permutation of
// 0..L-1, so every output slot is written exactly once and the result is a
// stable argsort: exact on distances and ids.  All threads of a warp read
// the same d_j at each step (a shared-memory broadcast).  A merge of the
// sorted pool with the sorted new block would need fewer compares; that
// redesign is later work.
#include <cuda_runtime.h>

__global__ void pool_merge_kernel(const float* __restrict__ pool_d,
                                  const int* __restrict__ pool_ids,
                                  const float* __restrict__ new_d,
                                  const int* __restrict__ new_ids,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_ids, int P, int Q) {
  extern __shared__ float smem[];
  const int L = P + Q;
  float* d = smem;
  int* ids = reinterpret_cast<int*>(smem + L);
  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    if (i < P) {
      d[i] = pool_d[b * P + i];
      ids[i] = pool_ids[b * P + i];
    } else {
      d[i] = new_d[b * Q + (i - P)];
      ids[i] = new_ids[b * Q + (i - P)];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float di = d[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) {
      const float dj = d[j];
      rank += (dj < di) | ((dj == di) & (j < i));
    }
    if (rank < P) {
      out_d[b * P + rank] = di;
      out_ids[b * P + rank] = ids[i];
    }
  }
}

extern "C" int pool_merge_launch(const void* pool_d, const void* pool_ids,
                                 const void* new_d, const void* new_ids,
                                 void* out_d, void* out_ids, int B, int P,
                                 int Q, void* stream) {
  const int L = P + Q;
  const int threads = ((L + 31) / 32) * 32 > 1024 ? 1024
                                                  : ((L + 31) / 32) * 32;
  const size_t smem = (size_t)L * (sizeof(float) + sizeof(int));
  pool_merge_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pool_d, (const int*)pool_ids, (const float*)new_d,
      (const int*)new_ids, (float*)out_d, (int*)out_ids, P, Q);
  return (int)cudaGetLastError();
}
