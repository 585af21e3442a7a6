// adc_distance: PQ asymmetric distance, d[b, c] = sum_m LUT[b, m, codes[b, c, m]].
//
// Replaces the TPU kernel `_adc_kernel` / `adc_distance_pallas`
// (src/repro/kernels/pq_adc.py), which avoids gathers on the VPU with a
// one-hot iota compare per subspace and keeps the LUT pinned in VMEM.
//
// What bounds it on an H100: device-memory bytes.  Each lane reads its LUT
// (M * 256 * 4 bytes: 96 KiB at M = 96) and C * M code bytes, and writes C
// floats; the M adds per row are negligible next to that (one add per
// 5 bytes read).  At the traversal's shapes (M = 96, C = 192) the LUT is
// ~85% of the bytes.
//
// Design: the lane's LUT goes into dynamic shared memory (loaded once per
// CTA with 16-byte loads), where the per-(row, m) random lookups that the
// TPU had to avoid are cheap.  Each thread takes one row and accumulates
// m = 0 .. M-1 in order, as the TPU kernel's fori_loop does and as the
// plain version does, so the result is bit-exact with it.  Rows are read
// with a stride of M bytes per thread; the codes are a sixth of the bytes
// and stay in L1.  Fusing the id -> code-row gather (codes[safe_n]) into
// the kernel, and sharing one LUT load across hops, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxDevices = 64;

__global__ void adc_distance_kernel(const float* __restrict__ lut,
                                    const uint8_t* __restrict__ codes,
                                    float* __restrict__ out, int C, int M) {
  extern __shared__ float4 slut4[];
  const float* slut = reinterpret_cast<const float*>(slut4);
  const size_t b = blockIdx.y;
  const float4* l4 = reinterpret_cast<const float4*>(lut + b * M * 256);
  for (int i = threadIdx.x; i < M * 64; i += blockDim.x) slut4[i] = l4[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const uint8_t* row = codes + (b * C + c) * M;
  float acc = 0.0f;
  for (int m = 0; m < M; ++m) acc += slut[m * 256 + row[m]];
  out[b * C + c] = acc;
}

extern "C" int adc_distance_launch(const void* lut, const void* codes,
                                   void* out, int B, int C, int M,
                                   void* stream) {
  const size_t smem = (size_t)M * 256 * sizeof(float);
  // The opt-in above 48 KiB is set once per device, to the largest LUT
  // seen there; a launch with a smaller LUT needs no new call.
  static int opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(adc_distance_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = (int)smem;
  }
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid((C + threads - 1) / threads, B);
  adc_distance_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)lut, (const uint8_t*)codes, (float*)out, C, M);
  return (int)cudaGetLastError();
}
