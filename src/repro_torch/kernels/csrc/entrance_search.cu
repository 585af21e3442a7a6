// entrance_search: every lane's whole beam search over the in-memory
// entrance graph, from its seed to convergence or max_hops, in one launch.
//
// Replaces no TPU kernel: the reference runs the search as a
// `lax.while_loop` (src/repro/core/search.py, `entrance_search`) over
// `adc_distance_pallas` and `pool_merge_pallas`, vmapped over a wave.  The
// port's host loop (core/search.py `_entrance_loop`, its plain version)
// issues ~25 small ops over all lanes an iteration and reads the device
// 4-5 times, for 56-58 iterations a wave of 10,000 at deep96's widths: the
// card idles while the host issues.
//
// What bounds it on an H100: latency.  Each lane reads its LUT (M * 256 *
// 4 bytes) once and, an iteration, one edge row, the neighbours' entrance
// ids and their code rows (a few hundred bytes, all L2-resident: the
// entrance graph and the codes of a deep96 index are under 1 MB); the
// chain edge row -> ids -> code rows -> M dependent adds -> merge is
// serial within a lane and runs up to max_hops times.
//
// Design: one warp a lane (one CTA of 32 threads), no block-wide barrier.
// - The LUT goes into dynamic shared memory once, as adc_distance.cu does
//   it; shared memory bounds the lanes an SM holds (6 at M 32, 2 at M 96).
// - The pool (P <= 64 distances and slots) lives in registers, slot j in
//   thread j % 32, and in two shared buffers the merge ranks into.
// - The expanded set is a bitmap over C slots in shared memory.  The
//   loop's hash set never overflows here (one key an iteration, at most
//   min(max_hops, C) keys), so both visited modes answer membership alike.
// - The argmin is a warp min over order_key.cuh's (distance, slot) keys:
//   the first of equal distances, as torch.argmin.
// - One thread a neighbour (R <= 64): ADC sums m = 0 .. M-1 in order from
//   0.0f, as adc_distance.cu and the plain version do, so the distances
//   are bit-equal.
// - The merge ranks by counting: the pool is ascending (it starts as
//   [d_seed, INF, ...] and every merge keeps it so), so pool slot j lands
//   at j + #(new < d_j) and new entry r at #(pool <= d_r) + #(new before
//   r in stable order): pool_merge_ref's stable order, the pool first on
//   ties, INF entries kept in place.
// - The seed (the first live slot) is found by ballots over ids; each
//   lane writes its iteration count, and the launch's largest and summed
//   counts add into `tally` by atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "order_key.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 3.4e38f;
constexpr int kMaxPool = 64;
constexpr int kMaxDeg = 64;
constexpr int kMaxDevices = 64;

// d = sum_m lut[m, row[m]], m in order from 0.0f.
__device__ __forceinline__ float adc_row(const float* slut,
                                         const uint8_t* row, int M) {
  float acc = 0.0f;
  if ((M & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 3) == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    for (int q = 0; q < (M >> 2); ++q) {
      const uint32_t x = __ldg(w + q);
      const float* l = slut + q * 1024;
      acc += l[x & 255u];
      acc += l[256 + ((x >> 8) & 255u)];
      acc += l[512 + ((x >> 16) & 255u)];
      acc += l[768 + (x >> 24)];
    }
  } else {
    for (int m = 0; m < M; ++m) acc += slut[m * 256 + __ldg(row + m)];
  }
  return acc;
}

__device__ __forceinline__ bool seen_has(const uint32_t* seen, int C,
                                         int s) {
  return s >= 0 && s < C && ((seen[s >> 5] >> (s & 31)) & 1u);
}

__global__ void __launch_bounds__(32)
entrance_search_kernel(const float* __restrict__ lut,
                       const uint8_t* __restrict__ codes,
                       const int* __restrict__ ids,
                       const int* __restrict__ edges,
                       int* __restrict__ out_main, float* __restrict__ out_d,
                       int* __restrict__ out_hops,
                       unsigned long long* __restrict__ tally, int M, int P,
                       int R, int C, int max_hops) {
  extern __shared__ float4 smem4[];
  float* slut = reinterpret_cast<float*>(smem4);
  float* spd = slut + M * 256;                    // [2][kMaxPool]
  int* spi = reinterpret_cast<int*>(spd + 2 * kMaxPool);  // [2][kMaxPool]
  float* snd = reinterpret_cast<float*>(spi + 2 * kMaxPool);  // [kMaxDeg]
  int* sni = reinterpret_cast<int*>(snd + kMaxDeg);           // [kMaxDeg]
  uint32_t* seen = reinterpret_cast<uint32_t*>(sni + kMaxDeg);
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;

  const float4* l4 = reinterpret_cast<const float4*>(lut + b * M * 256);
  for (int i = lane; i < M * 64; i += 32) smem4[i] = l4[i];
  for (int i = lane; i < (C + 31) / 32; i += 32) seen[i] = 0u;

  // seed: the first live slot (slot 0 where none is live, as argmax)
  int seed = 0;
  for (int base = 0; base < C; base += 32) {
    const int s = base + lane;
    const unsigned live = __ballot_sync(kFull, s < C && __ldg(ids + s) >= 0);
    if (live) {
      seed = base + __ffs(live) - 1;
      break;
    }
  }
  const int seed_main = __ldg(ids + seed);
  __syncwarp();

  // the pool: slot j in thread j % 32, entry k = j / 32
  float rd[2];
  int ri[2];
  bool unexp[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = lane + 32 * k;
    rd[k] = kInf;
    ri[k] = -1;
    if (j == 0) {
      ri[k] = seed;
      if (seed_main >= 0)
        rd[k] = adc_row(slut, codes + (size_t)seed_main * M, M);
    }
    unexp[k] = j < P && ri[k] >= 0;
    if (j < P) {
      spd[j] = rd[k];
      spi[j] = ri[k];
    }
  }
  __syncwarp();
  int cur = 0;
  int hops = 0;
  bool active = max_hops > 0 && __any_sync(kFull, unexp[0] || unexp[1]);
  while (active) {
    const float* pd = spd + cur * kMaxPool;
    const int* pi = spi + cur * kMaxPool;
    float* nd_out = spd + (cur ^ 1) * kMaxPool;
    int* ni_out = spi + (cur ^ 1) * kMaxPool;

    // expand the first unexpanded slot of least distance
    u64 best = ~0ull;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
      if (j < P) {
        const u64 key = order_key(unexp[k] ? rd[k] : kInf, j);
        best = key < best ? key : best;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, best, off);
      best = o < best ? o : best;
    }
    const int v = pi[key_pos(best)];
    if (lane == 0 && v >= 0 && v < C) seen[v >> 5] |= 1u << (v & 31);
    __syncwarp();
    const int vv = v > 0 ? v : 0;

    // its neighbours: valid where live, unexpanded and not in the pool
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = lane + 32 * k;
      if (r < R) {
        const int nb = __ldg(edges + (size_t)vv * R + r);
        bool in_pool = false;
        for (int j = 0; j < P; ++j) in_pool |= pi[j] == nb;
        const bool valid = nb >= 0 && !seen_has(seen, C, nb) && !in_pool;
        const int mid = nb >= 0 && nb < C ? __ldg(ids + nb) : -1;
        snd[r] = valid && mid >= 0
                     ? adc_row(slut, codes + (size_t)mid * M, M)
                     : kInf;
        sni[r] = valid ? nb : -1;
      }
    }
    __syncwarp();

    // merge: the P first of pool ++ new in stable ascending order
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
      if (j < P) {
        int rank = j;
        for (int r = 0; r < R; ++r) rank += snd[r] < rd[k];
        if (rank < P) {
          nd_out[rank] = rd[k];
          ni_out[rank] = ri[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = lane + 32 * k;
      if (r < R) {
        const float d = snd[r];
        int rank = 0;
        for (int j = 0; j < P; ++j) rank += pd[j] <= d;
        for (int q = 0; q < R; ++q) {
          const float e = snd[q];
          rank += e < d || (e == d && q < r);
        }
        if (rank < P) {
          nd_out[rank] = d;
          ni_out[rank] = sni[r];
        }
      }
    }
    __syncwarp();
    cur ^= 1;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = lane + 32 * k;
      if (j < P) {
        rd[k] = nd_out[j];
        ri[k] = ni_out[j];
        unexp[k] = ri[k] >= 0 && !seen_has(seen, C, ri[k]);
      }
    }
    ++hops;
    active = hops < max_hops && __any_sync(kFull, unexp[0] || unexp[1]);
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = lane + 32 * k;
    if (j < P) {
      out_main[b * P + j] =
          ri[k] >= 0 && ri[k] < C ? __ldg(ids + ri[k]) : -1;
      out_d[b * P + j] = rd[k];
    }
  }
  if (lane == 0) {
    out_hops[b] = hops;
    atomicMax(tally, (unsigned long long)hops);
    atomicAdd(tally + 1, (unsigned long long)hops);
  }
}

// Shared memory of a lane: the LUT, the pool's two buffers, the new
// block, the expanded bitmap.
static size_t entrance_smem_bytes(int M, int C) {
  return (size_t)M * 256 * sizeof(float) +
         (2 * kMaxPool + kMaxDeg) * (sizeof(float) + sizeof(int)) +
         (size_t)(C + 31) / 32 * sizeof(uint32_t);
}

extern "C" int entrance_search_launch(const void* lut, const void* codes,
                                      const void* ids, const void* edges,
                                      void* out_main, void* out_d,
                                      void* out_hops, void* tally, int B,
                                      int M, int P, int R, int C,
                                      int max_hops, void* stream) {
  if (P < 1 || P > kMaxPool || R < 1 || R > kMaxDeg || M < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = entrance_smem_bytes(M, C);
  // The opt-in above 48 KiB is set once per device, to the largest size
  // seen there.
  static int opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(entrance_search_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = (int)smem;
  }
  entrance_search_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const float*)lut, (const uint8_t*)codes, (const int*)ids,
      (const int*)edges, (int*)out_main, (float*)out_d, (int*)out_hops,
      (unsigned long long*)tally, M, P, R, C, max_hops);
  return (int)cudaGetLastError();
}
