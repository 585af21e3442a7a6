// rerank_l2: exact squared L2, d[b, s] = sum_k (xs[b, s, k] - q[b, k])^2,
// and rerank_l2_rows, the same with the rows read in place by id:
// d[b, s] = sum_k (vectors[ids[b, s], k] - q[b, k])^2, INF where the id is
// -1 (NaN where it is past the store, a caller's fault made visible).
//
// Replaces the TPU kernel `_rerank_kernel` / `rerank_l2_pallas`
// (src/repro/kernels/rerank_l2.py), which streams CASR groups of s rows
// through VMEM and computes ||q||^2 - 2 q.x + ||x||^2 with q.x on the MXU.
// The CASR stage runs casr_rerank.cu instead, and FreshDiskANN's buffer
// scan, where every lane scores the same rows, rerank_l2_shared.cu (the
// same body over tiles of pairs).  rerank_l2_rows carries the full rerank
// (search.full_rerank), which scores each lane's pool of ids: gathering
// those rows into a [B, S, D] temporary first would move every byte twice
// (50 MB for a wave of 256 pools of 64 at D = 768).  rerank_l2 stays for
// callers that hold the rows already.
//
// What bounds it on an H100: device-memory bytes.  Every candidate row is
// read once (D * 4 bytes: 3 KiB at D = 768) for 3 flops per element, far
// below the ~20 flops per byte where fp32 arithmetic would bind, and each
// lane reranks its own rows, so there is no reuse for tensor cores.
//
// Design: one warp per (lane, row), summing the row with the shared
// difference-form body in l2_row.cuh.  The sum order differs from the
// plain version's, hence the rtol 1e-5 / atol 1e-3 grade.  Both kernels
// and casr_rerank.cu run the same body on the same row, so a row's value
// does not depend on which of them computed it (rerank_l2_shared.cu
// builds the body's sums in its order, so the same holds there).
#include "l2_row.cuh"

__global__ void rerank_l2_kernel(const float* __restrict__ q,
                                 const float* __restrict__ xs,
                                 float* __restrict__ out, int B, int S,
                                 int D) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S) return;
  const long long b = warp / S;
  const float acc = row_sqdist(xs + warp * D, q + b * D, D, lane);
  if (lane == 0) out[warp] = acc;
}

extern "C" int rerank_l2_launch(const void* q, const void* xs, void* out,
                                int B, int S, int D, void* stream) {
  const int threads = 256;
  const long long warps = (long long)B * S;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  rerank_l2_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)xs, (float*)out, B, S, D);
  return (int)cudaGetLastError();
}

__global__ void rerank_l2_rows_kernel(const float* __restrict__ q,
                                      const float* __restrict__ vectors,
                                      const int* __restrict__ ids,
                                      float* __restrict__ out, int B, int S,
                                      int D, int N) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * S) return;
  const long long b = warp / S;
  const int id = ids[warp];
  if (id < 0 || id >= N) {
    if (lane == 0) out[warp] = id < 0 ? 3.4e38f : __int_as_float(0x7fc00000);
    return;
  }
  const float acc = row_sqdist(vectors + (long long)id * D, q + b * D, D,
                               lane);
  if (lane == 0) out[warp] = acc;
}

extern "C" int rerank_l2_rows_launch(const void* q, const void* vectors,
                                     const void* ids, void* out, int B,
                                     int S, int D, int N, void* stream) {
  const int threads = 256;
  const long long warps = (long long)B * S;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  rerank_l2_rows_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)q, (const float*)vectors, (const int*)ids, (float*)out,
      B, S, D, N);
  return (int)cudaGetLastError();
}
