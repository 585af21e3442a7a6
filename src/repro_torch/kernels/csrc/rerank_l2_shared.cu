// rerank_l2_shared: exact squared L2 of every query against the same rows,
// d[b, s] = ||rows[s] - q[b]||^2 for s < count and INF from s = count on:
// FreshDiskANN's buffer scan, where every lane of a search wave scores the
// whole in-memory buffer.
//
// Replaces the TPU kernel `_rerank_kernel` / `rerank_l2_pallas`
// (src/repro/kernels/rerank_l2.py:38), which the reference vmaps over the
// lanes with the buffer as every lane's rows (src/repro/core/engine.py:397)
// and which computes ||x||^2 - 2 q.x + ||q||^2 with q.x on the MXU.  The
// function is a [B, count] grid of pairs, so queries and rows are staged
// once per tile of pairs in shared memory instead of once per lane.
//
// The form: the difference form of l2_row.cuh, not the expanded one.  At
// the FineWeb-like data's norms (~7,680 a vector) the expanded form
// cancels where d is small (a buffered vector against itself): rounding
// its three terms alone costs ~1e-3, the repo's atol, and a 3xTF32
// tensor-core version of it missed the grade there (3.40e-3).  Each pair
// is summed as row_sqdist sums it: 32 partial sums, partial l the fmaf sum
// over float4 chunks l, l + 32, ... of (x - q)^2 in x, y, z, w order, then
// combined in warp_sum's butterfly order.  So d is bit-equal to rerank_l2
// and rerank_l2_rows on the same row, and a buffered vector's distance
// does not depend on which kernel computed it.
//
// What bounds it on an H100: operations, at the buffer sizes the engine
// runs (B = 256 lanes, 200 to 4,096 rows of D = 768): a subtract and an
// fmaf per element, 3 * B * count * D flops at 67 TFLOP/s fp32 (36 us at
// 256 x 4,096 x 768; as instructions, two per element at one a clock per
// 32 lanes, 48 us), against 2.3 us for the rows, queries and [B, S] output
// at 3.35 TB/s.
//
// Design: a CTA of 2 x 2 warps takes 16 x 16 tiles of pairs, a warp an
// 8 x 8 tile, lane l holding partial l of each of its 64 pairs: per stage
// it reads float4 column l of its 8 queries and 8 rows from shared memory
// (a quarter-warp reads 8 distinct 16-byte columns: no bank conflicts) for
// 512 subtracts and fmafs.  Stages of 32 float4 columns (128 floats) of the
// tile's queries and rows arrive in a ring of 3 by cp.async, zero-filled
// past D (adding 0 * 0 leaves a partial as it is).  Lane l holds pair
// i ^ 2l in its value i, so warp_sum's butterfly scatters with no select:
// at mask 16, 8, 4, 2, 1 every lane keeps the lower half of its values and
// adds the partner's upper half, ending with pairs 2l and 2l + 1.  The
// grid is as many CTAs as the card holds at once (three an SM: held to
// four, the compiler gives a thread fewer registers, and it ran slower);
// CTA b takes tiles b, b + gridDim.x, ..., its stages flowing through one
// ring across them, and the rows past the live tiles are written INF by
// the grid first.  Larger tiles (fewer bytes through L2) fit fewer warps
// on an SM and ran slower on the card.
//
// Limits (the wrapper checks them): D % 4 == 0 and 16-byte aligned rows
// (cp.async moves 16 bytes, and row_sqdist reads float4s there).
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kCols = 32;           // float4 columns a stage holds: a lane's
constexpr int kStages = 3;
constexpr int kTile = 8;            // a warp's pairs: kTile x kTile
constexpr int kWM = 2, kWN = 2;     // a CTA's warps: queries x rows
constexpr int kBM = kWM * kTile, kBN = kWN * kTile, kR = kBM + kBN;
constexpr int kThreads = kWM * kWN * 32;
constexpr int kSlots = kR * kCols / kThreads;   // a thread's loads a stage
constexpr int kSmem = kStages * kR * kCols * (int)sizeof(float4);
constexpr int kMaxDevices = 64;
static_assert(kR * kCols % kThreads == 0 && kBM % (kThreads / kCols) == 0,
              "even cp.async slots, queries apart from rows");
static_assert(kSmem <= 48 * 1024, "no opt-in to more shared memory");

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

// One step of the reduce-scatter: N values a lane, of which every lane
// keeps the lower half and adds to it lane ^ MASK's upper half (own +
// partner, as warp_sum adds).  Lane l's value i is pair i ^ 2l, so lane ^
// MASK's value i + N / 2 is the pair of lane l's value i.
template <int N, int MASK>
__device__ __forceinline__ void scatter_step(float (&v)[kTile * kTile]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    v[i] += __shfl_xor_sync(0xffffffffu, v[i + N / 2], MASK);
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 3)
    rerank_l2_shared_kernel(const float* __restrict__ q,
                            const float* __restrict__ rows,
                            float* __restrict__ out, int B, int S, int D,
                            int count) {
  extern __shared__ __align__(16) float4 smem[];  // kStages x [kR, kCols]
  const int tid = threadIdx.x;
  const int nq = (B + kBM - 1) / kBM, nr = (count + kBN - 1) / kBN;
  for (int i = blockIdx.x; i < B; i += gridDim.x)  // past the live tiles
    for (int j = nr * kBN + tid; j < S; j += kThreads)
      out[(long long)i * S + j] = kInf;
  const int tiles = nq * nr;
  if ((int)blockIdx.x >= tiles) return;
  const int d4 = D >> 2, nk = (d4 + kCols - 1) / kCols;
  const int n_stages = ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * nk;

  // A thread's cp.async slots: column c of tile rows r0 + v * kThreads /
  // 32 in every stage (queries in the first slots, then rows);
  // the rows out of range, and the columns past D, zero-fill from the
  // tensor's start (no byte is read).  Tile t: queries t % nq, rows t / nq.
  const int c = tid % kCols, r0 = tid / kCols;
  int l_k = 0, l_t = blockIdx.x, l_q = 0, l_x = 0;  // the next load
  auto load_next = [&](int slot) {
    if (l_k == 0) {
      l_q = (l_t % nq) * kBM + r0;
      l_x = (l_t / nq) * kBN + r0 - kBM;
    }
    float4* st = smem + slot * kR * kCols + r0 * kCols + c;
    const int k = l_k * kCols + c;
#pragma unroll
    for (int v = 0; v < kSlots; ++v) {
      const int rr = v * (kThreads / kCols);
      const bool is_q = rr < kBM;
      const int row = (is_q ? l_q : l_x) + rr;
      const bool ok = row < (is_q ? B : count) && k < d4;
      const float4* base = reinterpret_cast<const float4*>(is_q ? q : rows);
      cp_async16(st + rr * kCols, base + (ok ? (long long)row * d4 + k : 0),
                 ok);
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

  // lane l's value i = m * 8 + n is pair i ^ 2l: query m ^ mp, row n ^ np
  const int warp = tid >> 5, lane = tid & 31;
  const int mp = lane >> 2, np = (2 * lane) & (kTile - 1);
  const int wq = (warp / kWN) * kTile;              // warp's first query
  const int wx = kBM + (warp % kWN) * kTile;        // its first row (smem)
  float acc[kTile * kTile];
#pragma unroll
  for (int p = 0; p < kTile * kTile; ++p) acc[p] = 0.0f;
  int c_k = 0, c_t = blockIdx.x;                    // the tile summed

  for (int g = 0; g < n_stages; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                                // stage g landed
    if (g + kStages - 1 < n_stages) load_next((g + kStages - 1) % kStages);
    cp_async_commit();
    const float4* st = smem + (g % kStages) * kR * kCols + lane;
    float4 qv[kTile];
#pragma unroll
    for (int m = 0; m < kTile; ++m) qv[m] = st[(wq + (m ^ mp)) * kCols];
#pragma unroll
    for (int n = 0; n < kTile; ++n) {
      const float4 a = st[(wx + (n ^ np)) * kCols];
#pragma unroll
      for (int m = 0; m < kTile; ++m) {             // row_sqdist's order
        float& s = acc[m * kTile + n];
        float t = a.x - qv[m].x;
        s = fmaf(t, t, s);
        t = a.y - qv[m].y;
        s = fmaf(t, t, s);
        t = a.z - qv[m].z;
        s = fmaf(t, t, s);
        t = a.w - qv[m].w;
        s = fmaf(t, t, s);
      }
    }
    if (++c_k < nk) continue;

    // the tile is summed: warp_sum's butterfly, scattered, leaves pairs
    // 2 * lane and 2 * lane + 1 in values 0 and 1; then the next tile
    scatter_step<64, 16>(acc);
    scatter_step<32, 8>(acc);
    scatter_step<16, 4>(acc);
    scatter_step<8, 2>(acc);
    scatter_step<4, 1>(acc);
    const int i = (c_t % nq) * kBM + wq + lane / 4;
    const int j = (c_t / nq) * kBN + wx - kBM + 2 * (lane % 4);
    if (i < B) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j + e < S) out[(long long)i * S + j + e] =
            j + e < count ? acc[e] : kInf;
    }
#pragma unroll
    for (int e = 0; e < kTile * kTile; ++e) acc[e] = 0.0f;
    c_k = 0;
    c_t += gridDim.x;
  }
  cp_async_wait<0>();
}

extern "C" int rerank_l2_shared_launch(const void* q, const void* rows,
                                       void* out, int B, int S, int D,
                                       int count, void* stream) {
  static int resident[kMaxDevices];   // CTAs the card holds at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rerank_l2_shared_kernel, kThreads, kSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  // as many CTAs as the card holds, fewer where the live tiles and the
  // rows past them (one CTA a row) need fewer
  const long long tiles =
      (long long)((B + kBM - 1) / kBM) * ((count + kBN - 1) / kBN);
  long long grid = tiles > B ? tiles : B;
  grid = grid < resident[dev] ? grid : resident[dev];
  rerank_l2_shared_kernel<<<(unsigned)(grid > 0 ? grid : 1), kThreads, kSmem,
                            (cudaStream_t)stream>>>(
      (const float*)q, (const float*)rows, (float*)out, B, S, D, count);
  return (int)cudaGetLastError();
}
