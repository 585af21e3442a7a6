// order_key.cuh: a unique 64-bit sort key for a (distance, position) pair,
// shared by pool_merge.cu and casr_rerank.cu.
//
// The high word holds the order-preserving bits of d (the sign bit set for
// d >= 0, all bits flipped for d < 0; -0.0 first becomes +0.0, since `<`
// treats the two as equal), the low word the position.  So key_a < key_b
// exactly when d_a < d_b, or d_a == d_b and pos_a < pos_b: ascending keys
// are the stable argsort of the distances.  Inputs carry no NaN (padding
// is 3.4e38), and no key of a real element equals the all-ones pad key.
#pragma once
#include <stdint.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 order_key(float d, int pos) {
  uint32_t u = __float_as_uint(d);
  if ((u << 1) == 0) u = 0;  // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (uint32_t)pos;
}

__device__ __forceinline__ int key_pos(u64 key) { return (int)(uint32_t)key; }
