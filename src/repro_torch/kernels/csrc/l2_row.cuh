// l2_row.cuh: the exact squared-L2 body shared by rerank_l2.cu and
// casr_rerank.cu, so both kernels give the same value for the same row.
// rerank_l2_shared.cu builds the same partial sums in the same order over
// a tile of pairs, so it gives that value too.
//
// One warp sums sum_k (x[k] - q[k])^2 for one row: the difference form
// (the expanded form ||q||^2 - 2 q.x + ||x||^2 cancels at large norms),
// accumulated in fp32 with fmaf, then a butterfly shuffle reduction so
// every lane of the warp returns the total.  Rows whose pointers are
// 16-byte aligned with D % 4 == 0 are read as float4 (each lane takes four
// neighbouring elements, lanes on neighbouring 16 bytes); other rows one
// float at a time.  The path depends only on D and the alignment, so a
// row's value does not depend on which kernel computed it, nor on whether
// casr_rerank.cu read the row from device memory or from its ring of
// rows in shared memory (row_sqdist_shared: the same float4 body).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The float4 body: lane k sums elements 4k .. 4k + 3, 4(k + 32) .. of the
// row, in that order, through fmaf; x read through the read-only path
// from device memory (kGlobal) or from shared memory.
template <bool kGlobal>
__device__ __forceinline__ float row_sqdist4(const float4* __restrict__ x4,
                                             const float4* __restrict__ q4,
                                             int D, int lane) {
  float acc = 0.0f;
#pragma unroll 4
  for (int k = lane; k < (D >> 2); k += 32) {
    const float4 a = kGlobal ? __ldg(x4 + k) : x4[k];
    const float4 b = q4[k];
    float t = a.x - b.x;
    acc = fmaf(t, t, acc);
    t = a.y - b.y;
    acc = fmaf(t, t, acc);
    t = a.z - b.z;
    acc = fmaf(t, t, acc);
    t = a.w - b.w;
    acc = fmaf(t, t, acc);
  }
  return warp_sum(acc);
}

__device__ __forceinline__ float row_sqdist(const float* __restrict__ x,
                                            const float* __restrict__ q,
                                            int D, int lane) {
  if ((D & 3) == 0 && ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(q)) & 15) == 0)
    return row_sqdist4<true>(reinterpret_cast<const float4*>(x),
                             reinterpret_cast<const float4*>(q), D, lane);
  float acc = 0.0f;
  for (int k = lane; k < D; k += 32) {
    const float t = __ldg(x + k) - q[k];
    acc = fmaf(t, t, acc);
  }
  return warp_sum(acc);
}

// row_sqdist of a row held in shared memory (16-byte aligned, D % 4 == 0,
// as the float4 body wants): the same sums in the same order, so the same
// value as the row read from device memory.
__device__ __forceinline__ float row_sqdist_shared(const float* x,
                                                   const float* q, int D,
                                                   int lane) {
  return row_sqdist4<false>(reinterpret_cast<const float4*>(x),
                            reinterpret_cast<const float4*>(q), D, lane);
}
