// rerank_l2: exact squared L2, d[b, s] = sum_k (xs[b, s, k] - q[b, k])^2.
//
// Replaces the TPU kernel `_rerank_kernel` / `rerank_l2_pallas`
// (src/repro/kernels/rerank_l2.py), which streams CASR groups of s rows
// through VMEM and computes ||q||^2 - 2 q.x + ||x||^2 with q.x on the MXU.
// The main path's CASR stage runs casr_rerank.cu instead; this kernel
// serves callers that rerank rows they already hold (a full rerank).
//
// What bounds it on an H100: device-memory bytes.  Every candidate row is
// read once (D * 4 bytes: 3 KiB at D = 768) for 3 flops per element, far
// below the ~20 flops per byte where fp32 arithmetic would bind, and each
// lane reranks its own rows, so there is no reuse for tensor cores.
//
// Design: one warp per (lane, row), summing the row with the shared
// difference-form body in l2_row.cuh.  The sum order differs from the
// plain version's, hence the rtol 1e-5 / atol 1e-3 grade.
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
