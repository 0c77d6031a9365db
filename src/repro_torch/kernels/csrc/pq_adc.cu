// PQ asymmetric-distance (ADC) lookup on Hopper:
//     out[n] = sum_j table[j, codes[n, j]],   codes (N, m) uint8, table (m, 256) f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_adc.py::adc_lookup
// (body _adc_kernel).  The TPU has no fast per-lane gather, so that kernel
// contracts a (BN, m, 256) one-hot against the table on the MXU.  Hopper
// gathers from shared memory natively, so this kernel is the plain lookup.
//
// What bounds it on the H100: bytes.  Each code row is m bytes read once and
// one float written, and the table (m KB) is read once per block; the work is
// m shared-memory loads and adds per row, far below the FP32 and shared-memory
// rates.  At a graph search round (N ~ 100 rows, m = 48) there is almost no
// work at all: the launch itself is the cost.
//
// Design (simple first):
// * the whole (m, 256) table is staged in dynamic shared memory at block
//   start: 48 KB at m = 48, 120 KB at m = 120 (above 48 KB the launch sets
//   cudaFuncAttributeMaxDynamicSharedMemorySize; a block may use 227 KB);
// * one thread per code row, grid-stride over the rows, with as many blocks
//   as fit on the SMs at once (fewer table copies than one block per 256 rows);
// * a row's bytes come in 4-byte loads when m % 4 == 0 and the codes are
//   4-byte aligned, byte by byte otherwise;
// * the sum is f32, in order j = 0 .. m-1.
// Later: a bank-conflict-aware table layout, warp-cooperative code loads, and
// several queries' tables per launch.
#include "cuda_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KSUB = 256;

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
adc_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ table,
           float* __restrict__ out, long long N, int m) {
  extern __shared__ float lut[];              // (m, 256) f32
  for (int e = threadIdx.x; e < m * KSUB; e += THREADS) lut[e] = table[e];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long n = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       n < N; n += stride) {
    const uint8_t* row = codes + n * m;
    float acc = 0.f;
    if (VEC4) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
      for (int w = 0; w < m / 4; ++w) {
        const uint32_t v = words[w];
        const float* t = lut + 4 * w * KSUB;
        acc += t[v & 0xffu];
        acc += t[KSUB + ((v >> 8) & 0xffu)];
        acc += t[2 * KSUB + ((v >> 16) & 0xffu)];
        acc += t[3 * KSUB + (v >> 24)];
      }
    } else {
      for (int j = 0; j < m; ++j) acc += lut[j * KSUB + row[j]];
    }
    out[n] = acc;
  }
}

template <bool VEC4>
int launch(const uint8_t* codes, const float* table, float* out, long long N,
           int m, cudaStream_t stream) {
  const int smem = m * KSUB * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      adc_kernel<VEC4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, adc_kernel<VEC4>, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long need = (N + THREADS - 1) / THREADS;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < fit ? need : fit);
  adc_kernel<VEC4><<<grid, THREADS, smem, stream>>>(codes, table, out, N, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes (N, m) uint8 row-major, table (m, 256) f32, out (N,) f32; N >= 1,
// 1 <= m <= 227 (the table must fit one block's shared memory).
int adc_lookup_u8(const void* codes, const void* table, void* out,
                  long long N, int m, void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = m % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 4 == 0;
  return vec4 ? launch<true>(c, t, o, N, m, s) : launch<false>(c, t, o, N, m, s);
}

}  // extern "C"
