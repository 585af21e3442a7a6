// rerank_l2_shared: exact squared L2 of every query against the same rows,
// d[b, s] = ||rows[s] - q[b]||^2 for s < count and INF from s = count on:
// FreshDiskANN's buffer scan, where every lane of a search wave scores the
// whole in-memory buffer.
//
// Replaces the TPU kernel `_rerank_kernel` / `rerank_l2_pallas`
// (src/repro/kernels/rerank_l2.py:38), which the reference vmaps over the
// lanes with the buffer as every lane's rows (src/repro/core/engine.py:397)
// and which computes ||x||^2 - 2 q.x + ||q||^2 with q.x on the MXU.  The
// function is a [B, count] grid of pairs: one product Q X^T, as there.
//
// What bounds it on an H100: operations.  The difference form costs a
// subtract and an fmaf an element on the CUDA cores, 3 B count D fp32
// operations (36 us at 256 x 4,096 x 768 at 67 TFLOP/s); the expanded form
// puts q.x on the tensor cores, three TF32 products (2 B count D each) at
// 495 TFLOP/s, 9.8 us there, against 2.3 us for the rows, queries and
// [B, S] output at 3.35 TB/s.
//
// The form, and why it is exact enough.  Both sides are shifted by one
// vector c, the mean of the first min(count, 16) rows (computed by every
// CTA in the same order): d = ||x'||^2 + ||q'||^2 - 2 q'.x' with x' = x - c
// and q' = q - c, exact under the translation, its terms of the size of
// the buffer's spread and not of its distance from the origin (4,096
// near-duplicates of one vector: ~2 a norm instead of ~770).  The norms
// are fp32 sums (each lane 8 squares a stage of 32 elements, a tree over
// the 4 lanes, the stages added in order); q'.x' is 3xTF32 on the tensor
// cores: each operand split into a TF32 high part (rounded as cvt.rna
// rounds) and a TF32 low part (the rest, rounded so), lo.hi + hi.lo +
// hi.hi by mma.sync m16n8k8 with fp32 accumulation, a fresh accumulator
// each stage added into an fp32 total (with K-warps, each its own, the
// totals added in a tree).  Its error |d^ - d| is bounded by eps S, with
// S = ||q'||^2 + ||x'||^2:
//   - the norms: 34 fp32 roundings a norm, each below u = 2^-24 of its
//     partial sum: as random errors (Higham and Mary's probabilistic
//     bound), ~sqrt(34 / 3) u ||.||^2 rms;
//   - the products: the dropped lo.lo terms and the low parts' rounding,
//     3 * 2^-22 |q'_k x'_k| (<= 0.4 u S in all); the tensor core's
//     accumulation, 12 mma a stage, taken as truncating (2u a step, biased)
//     on |q'.x'| <= S / 2, and the 24 stage additions (u each);
//   - the shift and the last two operations: ~4 u S.
// eps = 16 u = 2^-20 (ops.SHARED_EPS) bounds it with margin: the host
// mirror of this arithmetic with truncating accumulation
// (tests/test_torch_kernels.py, FineWeb-like rows and near-duplicates)
// stays within 0.55 eps S, and chip_smoke.py prints the card's unguarded
// error over eps S for each case it grades.
//
// The guard (tau = ops.SHARED_TAU = eps (1 + 1 / rtol), rtol = 1e-5, the
// rerank grade's): a pair with d^ <= tau S is recomputed in the difference
// form with row_sqdist (l2_row.cuh), bit-equal there to rerank_l2_rows and
// rerank_l2; a buffered vector queried by itself (d^ ~ 0) always is.  An
// unflagged pair has d >= d^ - eps S > (tau - eps) S = eps S / rtol, so
// its error eps S < rtol d: within the grade.  A pair with exact d <=
// (tau - 2 eps) S has d^ <= (tau - eps) S: flagged.  Each CTA lists its
// flagged pairs in shared memory and its warps recompute them, one a warp,
// at the end of each tile (from the ring where it still holds the whole
// tile, else from device memory); no second launch.
//
// Design: a persistent grid (as many CTAs as the card holds, fewer where
// the live tiles and the rows past them, one CTA a row, need fewer), CTA
// b taking output tiles b, b + gridDim.x, ..., its stages flowing through
// one ring across them; the columns past the live tiles are written INF
// by the CTAs that have no tile, or by every CTA after its tiles.  A stage
// holds 32 elements of D for each K-warp, of the tile's queries and rows,
// loaded by cp.async (zero-filled past D, past B and past count: zeros add
// nothing), 16-byte chunks swizzled by row parity so a quarter-warp's
// fragment loads hit 32 distinct banks.  Lane (g, t) of a warp takes
// elements 4t .. 4t + 3 of each 16 of a row: k-slots t and t + 4 of two
// mma steps are elements (4t, 4t + 1) and (4t + 2, 4t + 3), the same
// permutation of k for both operands.  At the end of a tile each warp's
// sums go through shared memory, where the whole block forms d^, applies
// the guard and writes the tile row by row.  Three tile shapes, the
// largest whose tiles fill half the card: 64 x 128 pairs, 2 x 4 warps of
// 32 x 32 each over the whole of D (4,096 rows); 32 x 32 pairs, and 16 x
// 16, 8 warps each over an eighth of D (K-warps, their sums added in a
// fixed tree), so that a buffer of 10 or 200 rows is not a chain of 24
// stages walked by one warp a scheduler.
//
// Limits (the wrapper checks them): D % 4 == 0 and 16-byte aligned rows
// (cp.async moves 16 bytes, and row_sqdist reads float4s there), D <=
// 8,192 (c lives in shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

#include "l2_row.cuh"

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kWarpKs = 32;          // elements of a stage a warp sums
constexpr int kShiftRows = 16;       // c: the mean of the first rows
constexpr int kMaxD = 8192;
constexpr int kMaxDevices = 64;

template <int WMT, int WNT, int WARPS_M, int WARPS_N, int WARPS_K,
          int STAGES>
struct Shape {
  static constexpr int kWmt = WMT, kWnt = WNT;      // m16 / n8 tiles a warp
  static constexpr int kWarpsN = WARPS_N, kWarpsK = WARPS_K;
  static constexpr int kStages = STAGES;
  static constexpr int kBM = 16 * WMT * WARPS_M;    // queries a tile
  static constexpr int kBN = 8 * WNT * WARPS_N;     // rows a tile
  static constexpr int kRows = kBM + kBN;
  static constexpr int kKs = kWarpKs * WARPS_K;     // elements a stage
  static constexpr int kChunks = kKs / 4;           // 16-byte chunks a row
  static constexpr int kWarps = WARPS_M * WARPS_N * WARPS_K;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlots = kRows * kChunks / kThreads;
  static constexpr int kStride = kBN + 8;           // a partial-sum row
  static constexpr int kList = kBM * kBN;           // flagged pairs, at most
  static_assert(kRows * kChunks % kThreads == 0, "even cp.async slots");
  static_assert(kList <= 65536 && kList % 2 == 0,
                "a tile's pair fits 16 bits; the count after them aligned");

  // the ring, the shift c, each K-warp's dot and norm sums, the list
  static size_t smem(int D) {
    const int cpad = (D + kKs - 1) / kKs * kKs;
    return (size_t)kStages * kRows * kChunks * 16 + (size_t)cpad * 4 +
           (size_t)WARPS_K * (kBM * kStride + kBM + kBN) * 4 +
           (size_t)kList * 2 + 16;
  }
};
// 64 x 128 pairs, 2 x 4 warps of 32 x 32 over the whole of D; 32 x 32
// pairs, 8 warps of 32 x 32 each over an eighth of each 256 elements; and
// 16 x 16 pairs, 8 warps of 16 x 16 over an eighth each
using Large = Shape<2, 4, 2, 4, 1, 3>;
using Mid = Shape<2, 4, 1, 1, 8, 2>;
using Tiny = Shape<1, 2, 1, 1, 8, 3>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (half away from zero
// at the 13th mantissa bit, the low 13 bits cut), in two integer
// operations instead of a conversion
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (below 2^-22 |x|): two TF32 parts.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 c) {
  return make_float4(a.x - c.x, a.y - c.y, a.z - c.z, a.w - c.w);
}

__device__ __forceinline__ float sq4(float4 a, float s) {
  s = fmaf(a.x, a.x, s);
  s = fmaf(a.y, a.y, s);
  s = fmaf(a.z, a.z, s);
  return fmaf(a.w, a.w, s);
}

__device__ __forceinline__ float pick(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// row_sqdist (l2_row.cuh) of tile row x against tile row qr, read from the
// ring whose stage g0 + s holds elements 4 kChunks s .. of the tile: the
// same partial sums in the same order, so the same value.
template <class Sh>
__device__ __forceinline__ float ring_sqdist(const float4* ring, int g0,
                                             int x, int qr, int d4,
                                             int lane) {
  constexpr int kChunks = Sh::kChunks, kRows = Sh::kRows;
  float acc = 0.0f;
  for (int k = lane; k < d4; k += 32) {
    const int c = k % kChunks;
    const float4* st = ring + ((g0 + k / kChunks) % Sh::kStages) * kRows *
                                  kChunks;
    const int cx = (c & ~7) + ((c & 7) ^ ((x & 1) << 2));
    const int cq = (c & ~7) + ((c & 7) ^ ((qr & 1) << 2));
    const float4 a = st[x * kChunks + cx];
    const float4 b = st[qr * kChunks + cq];
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

// v[0] + ... + v[K - 1] as a pairwise tree: the K-warps' sums combined
template <int K>
__device__ __forceinline__ float tree_sum(float (&v)[K]) {
#pragma unroll
  for (int h = 1; h < K; h *= 2)
#pragma unroll
    for (int w = 0; w + h < K; w += 2 * h) v[w] += v[w + h];
  return v[0];
}

template <class Sh>
__global__ void __launch_bounds__(Sh::kThreads)
    rerank_l2_shared_kernel(const float* __restrict__ q,
                            const float* __restrict__ rows,
                            float* __restrict__ out,
                            uint8_t* __restrict__ flags, int B, int S, int D,
                            int count, float tau) {
  constexpr int kBM = Sh::kBM, kBN = Sh::kBN, kRows = Sh::kRows;
  constexpr int kWmt = Sh::kWmt, kWnt = Sh::kWnt, kWK = Sh::kWarpsK;
  constexpr int kThreads = Sh::kThreads, kChunks = Sh::kChunks;
  constexpr int kStages = Sh::kStages, kStride = Sh::kStride;
  extern __shared__ __align__(16) float4 smem[];
  const int tid = threadIdx.x;
  const int nq = (B + kBM - 1) / kBM, nr = (count + kBN - 1) / kBN;
  const int tiles = nq * nr;
  // the columns past the live tiles: by the CTAs that have no tile, where
  // there are any, else by every CTA once its tiles are done
  const int spare = (int)gridDim.x - tiles;
  if (spare > 0 && (int)blockIdx.x >= tiles) {
    for (int i = blockIdx.x - tiles; i < B; i += spare)
      for (int j = nr * kBN + tid; j < S; j += kThreads)
        out[(long long)i * S + j] = kInf;
    return;
  }

  const int d4 = D >> 2, nk = (D + Sh::kKs - 1) / Sh::kKs;
  float4* ring = smem;                          // [kStages][kRows][kChunks]
  float4* c4 = ring + kStages * kRows * kChunks;          // [nk * kChunks]
  float* red = reinterpret_cast<float*>(c4 + nk * kChunks);  // [kWK][kBM][.]
  float* nrm_q = red + kWK * kBM * kStride;               // [kWK][kBM]
  float* nrm_x = nrm_q + kWK * kBM;                       // [kWK][kBN]
  uint16_t* list = reinterpret_cast<uint16_t*>(nrm_x + kWK * kBN);
  int* list_n = reinterpret_cast<int*>(list + Sh::kList);
  if (tid == 0) *list_n = 0;
  const int n_stages = ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * nk;

  // cp.async: slot v of a thread is chunk v * kThreads + tid of the stage
  // (row / kChunks, chunk % kChunks), queries first, then rows; out of
  // range (a query past B, a row past count, a chunk past D) zero-fills
  // from the tensor's start, no byte read.  Within each 8 chunks (a
  // K-warp's) a row's chunks are swizzled by its parity.  Tile t: queries
  // t % nq, rows t / nq.
  int l_k = 0, l_t = blockIdx.x;                         // the next load
  auto load_next = [&](int slot) {
    float4* st = ring + slot * kRows * kChunks;
    const int q0 = (l_t % nq) * kBM, x0 = (l_t / nq) * kBN - kBM;
#pragma unroll
    for (int v = 0; v < Sh::kSlots; ++v) {
      const int idx = v * kThreads + tid;
      const int r = idx / kChunks, ch = idx % kChunks;
      const int k = l_k * kChunks + ch;
      const bool is_q = r < kBM;
      const int row = (is_q ? q0 : x0) + r;
      const bool ok = row < (is_q ? B : count) && k < d4;
      const float4* base = reinterpret_cast<const float4*>(is_q ? q : rows);
      cp_async16(st + r * kChunks + (ch ^ ((r & 1) << 2)),
                 base + (ok ? (long long)row * d4 + k : 0), ok);
    }
    if (++l_k == nk) {
      l_k = 0;
      l_t += gridDim.x;
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_next(s);
    cp_async_commit();
  }

  // c, the shift: the mean of the first min(count, 16) rows, summed in row
  // order (the same bits in every CTA), zero past D
  {
    const int m = count < kShiftRows ? count : kShiftRows;
    const float inv = 1.0f / (float)m;
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    for (int k = tid; k < nk * kChunks; k += kThreads) {
      float4 v[kShiftRows];                    // every load in flight
#pragma unroll
      for (int r = 0; r < kShiftRows; ++r)
        v[r] = r < m && k < d4 ? __ldg(r4 + (long long)r * d4 + k)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 s = v[0];
#pragma unroll
      for (int r = 1; r < kShiftRows; ++r) {
        s.x += v[r].x;
        s.y += v[r].y;
        s.z += v[r].z;
        s.w += v[r].w;
      }
      c4[k] = make_float4(s.x * inv, s.y * inv, s.z * inv, s.w * inv);
    }
  }

  // warp = (K-warp wk, query block wm, row block wn): its 32 x 32 pairs
  // (kWmt m16 x kWnt n8 tiles) over chunks 8 wk .. 8 wk + 7 of each stage
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wk = warp % kWK, wmn = warp / kWK;
  const int wm0 = (wmn / Sh::kWarpsN) * 16 * kWmt;      // warp's queries
  const int wn0 = (wmn % Sh::kWarpsN) * 8 * kWnt;       // and rows
  const int sw = (g & 1) << 2;                          // its rows' swizzle
  float tot[kWmt][kWnt][4], acc[kWmt][kWnt][4];
  float na[kWmt][2], pa[kWmt][2], nb[kWnt], pb[kWnt];   // norms, partials
  auto clear = [&]() {
#pragma unroll
    for (int mi = 0; mi < kWmt; ++mi) {
      na[mi][0] = na[mi][1] = pa[mi][0] = pa[mi][1] = 0.f;
#pragma unroll
      for (int ni = 0; ni < kWnt; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mi][ni][e] = acc[mi][ni][e] = 0.f;
    }
#pragma unroll
    for (int ni = 0; ni < kWnt; ++ni) nb[ni] = pb[ni] = 0.f;
  };
  clear();
  int c_k = 0, c_t = blockIdx.x;                         // the tile summed

  for (int gi = 0; gi < n_stages; ++gi) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                                     // stage gi landed
    if (gi + kStages - 1 < n_stages) load_next((gi + kStages - 1) % kStages);
    cp_async_commit();
    const float4* st = ring + (gi % kStages) * kRows * kChunks + 8 * wk;
#pragma unroll
    for (int j = 0; j < 2; ++j) {                        // 16 elements each
      const int ch = (4 * j + t) ^ sw;
      const float4 cv = c4[c_k * kChunks + 8 * wk + 4 * j + t];
      float4 a[kWmt][2], b[kWnt];
#pragma unroll
      for (int mi = 0; mi < kWmt; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          a[mi][r] = sub4(st[(wm0 + mi * 16 + g + 8 * r) * kChunks + ch], cv);
          pa[mi][r] = sq4(a[mi][r], pa[mi][r]);
        }
#pragma unroll
      for (int ni = 0; ni < kWnt; ++ni) {
        b[ni] = sub4(st[(kBM + wn0 + ni * 8 + g) * kChunks + ch], cv);
        pb[ni] = sq4(b[ni], pb[ni]);
      }
#pragma unroll
      for (int step = 0; step < 2; ++step) {             // (x, y), (z, w)
        uint32_t ah[kWmt][4], al[kWmt][4], bh[kWnt][2], bl[kWnt][2];
#pragma unroll
        for (int mi = 0; mi < kWmt; ++mi) {
          split_tf32(pick(a[mi][0], 2 * step), ah[mi][0], al[mi][0]);
          split_tf32(pick(a[mi][1], 2 * step), ah[mi][1], al[mi][1]);
          split_tf32(pick(a[mi][0], 2 * step + 1), ah[mi][2], al[mi][2]);
          split_tf32(pick(a[mi][1], 2 * step + 1), ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < kWnt; ++ni) {
          split_tf32(pick(b[ni], 2 * step), bh[ni][0], bl[ni][0]);
          split_tf32(pick(b[ni], 2 * step + 1), bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < kWmt; ++mi)
#pragma unroll
          for (int ni = 0; ni < kWnt; ++ni) {
            mma_tf32(acc[mi][ni], al[mi], bh[ni]);
            mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
            mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
          }
      }
    }
    // the stage's sums into the totals: products, then each norm's 32
    // squares (a tree over the 4 lanes of a row)
#pragma unroll
    for (int mi = 0; mi < kWmt; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWnt; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[mi][ni][e] += acc[mi][ni][e];
          acc[mi][ni][e] = 0.f;
        }
#pragma unroll
    for (int mi = 0; mi < kWmt; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p = pa[mi][r];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        na[mi][r] += p;
        pa[mi][r] = 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < kWnt; ++ni) {
      float p = pb[ni];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      nb[ni] += p;
      pb[ni] = 0.f;
    }
    if (++c_k < nk) continue;

    // the tile is summed: each warp's sums into shared memory (lane (g, t)
    // holds queries g, g + 8 of each m16 tile and rows 2t, 2t + 1 of each
    // n8 tile; the norms of its rows g, g + 8 and of rows g of each n8)
    float* my = red + wk * kBM * kStride;
#pragma unroll
    for (int mi = 0; mi < kWmt; ++mi)
#pragma unroll
      for (int ni = 0; ni < kWnt; ++ni)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              my + (wm0 + mi * 16 + g + 8 * r) * kStride + wn0 + ni * 8 +
              2 * t) = make_float2(tot[mi][ni][2 * r], tot[mi][ni][2 * r + 1]);
    if (t == 0 && wn0 == 0)
#pragma unroll
      for (int mi = 0; mi < kWmt; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          nrm_q[wk * kBM + wm0 + mi * 16 + g + 8 * r] = na[mi][r];
    if (t == 0 && wm0 == 0)
#pragma unroll
      for (int ni = 0; ni < kWnt; ++ni)
        nrm_x[wk * kBN + wn0 + ni * 8 + g] = nb[ni];
    __syncthreads();

    // d^ and the guard a pair, the K-warps' sums combined in a fixed tree
    const int i0 = (c_t % nq) * kBM, j0 = (c_t / nq) * kBN;
    for (int p = tid; p < kBM * kBN; p += kThreads) {
      const int il = p / kBN, jl = p % kBN;
      const int i = i0 + il, j = j0 + jl;
      if (i >= B || j >= S) continue;
      const long long o = (long long)i * S + j;
      if (j >= count) {
        out[o] = kInf;
        continue;
      }
      float dv[kWK], qv[kWK], xv[kWK];
#pragma unroll
      for (int w = 0; w < kWK; ++w) {
        dv[w] = red[(w * kBM + il) * kStride + jl];
        qv[w] = nrm_q[w * kBM + il];
        xv[w] = nrm_x[w * kBN + jl];
      }
      const float dot = tree_sum(dv);
      const float sn = tree_sum(qv) + tree_sum(xv);
      const float d = fmaf(-2.0f, dot, sn);
      const bool flag = d <= tau * sn;
      if (flag)
        list[atomicAdd(list_n, 1)] = (uint16_t)p;
      else
        out[o] = d;
      if (flags != nullptr) flags[o] = flag ? 1 : 0;
    }
    __syncthreads();
    // the flagged pairs, one a warp, in the row body's difference form:
    // from the ring where the whole tile is still there (D within the ring,
    // and no next tile's stage loading), else from device memory
    const int n_flag = *list_n;
    const bool held = nk <= kStages && c_t + (int)gridDim.x >= tiles;
    for (int f = warp; f < n_flag; f += Sh::kWarps) {
      const int p = list[f];
      const int i = i0 + p / kBN, j = j0 + p % kBN;
      const float v =
          held ? ring_sqdist<Sh>(ring, gi + 1 - nk, kBM + p % kBN, p / kBN,
                                 d4, lane)
               : row_sqdist(rows + (long long)j * D, q + (long long)i * D, D,
                            lane);
      if (lane == 0) out[(long long)i * S + j] = v;
    }
    __syncthreads();
    if (tid == 0) *list_n = 0;
    clear();
    c_k = 0;
    c_t += gridDim.x;
  }
  cp_async_wait<0>();
  if (spare <= 0)
    for (int i = blockIdx.x; i < B; i += gridDim.x)
      for (int j = nr * kBN + tid; j < S; j += kThreads)
        out[(long long)i * S + j] = kInf;
}

struct Resident {             // CTAs the card holds at once, by smem size
  size_t smem = 0;
  int ctas = 0;
};

template <class Sh>
int launch_shape(const float* q, const float* rows, float* out,
                 uint8_t* flags, int B, int S, int D, int count, float tau,
                 int dev, int sms, cudaStream_t stream) {
  static Resident resident[kMaxDevices];
  static bool opted[kMaxDevices];
  cudaError_t err;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(rerank_l2_shared_kernel<Sh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Sh::smem(kMaxD));
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  const size_t smem = Sh::smem(D);
  Resident& res = resident[dev];
  if (res.smem != smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rerank_l2_shared_kernel<Sh>, Sh::kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    res.ctas = (per_sm > 0 ? per_sm : 1) * sms;
    res.smem = smem;
  }
  // as many CTAs as the card holds, fewer where the live tiles and the
  // rows past them (one CTA a row) need fewer
  const long long tiles = (long long)((B + Sh::kBM - 1) / Sh::kBM) *
                          ((count + Sh::kBN - 1) / Sh::kBN);
  long long grid = tiles > B ? tiles : B;
  grid = grid < res.ctas ? grid : res.ctas;
  rerank_l2_shared_kernel<Sh><<<(unsigned)(grid > 0 ? grid : 1),
                                Sh::kThreads, smem, stream>>>(
      q, rows, out, flags, B, S, D, count, tau);
  return (int)cudaGetLastError();
}

}  // namespace

// flags: null, or a [B, S] uint8 the kernel marks 1 where it recomputed a
// pair (measurement only); tau: the guard's threshold (-inf: none).
extern "C" int rerank_l2_shared_launch(const void* q, const void* rows,
                                       void* out, void* flags, int B, int S,
                                       int D, int count, float tau,
                                       void* stream) {
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (D > kMaxD || (D & 3)) return (int)cudaErrorInvalidValue;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sms_of[dev];
  // the largest tile whose tiles fill half the card, else the smallest
  auto tiles = [&](int bm, int bn) {
    return (long long)((B + bm - 1) / bm) * ((count + bn - 1) / bn);
  };
  auto* qf = (const float*)q;
  auto* rf = (const float*)rows;
  auto* of = (float*)out;
  auto* ff = (uint8_t*)flags;
  auto* st = (cudaStream_t)stream;
  if (2 * tiles(Large::kBM, Large::kBN) >= sms)
    return launch_shape<Large>(qf, rf, of, ff, B, S, D, count, tau, dev, sms,
                               st);
  if (2 * tiles(Mid::kBM, Mid::kBN) >= sms)
    return launch_shape<Mid>(qf, rf, of, ff, B, S, D, count, tau, dev, sms,
                             st);
  return launch_shape<Tiny>(qf, rf, of, ff, B, S, D, count, tau, dev, sms,
                            st);
}
