// PQ asymmetric-distance (ADC) lookup on Hopper:
//     out[n] = sum_j table[j, codes[n, j]],   codes (N, m) uint8, table (m, 256) f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_adc.py::adc_lookup
// (body _adc_kernel).  The TPU has no fast per-lane gather, so that kernel
// contracts a (BN, m, 256) one-hot against the table on the MXU.  Hopper
// gathers natively, so this kernel is the plain lookup.
//
// What bounds it on the H100: bytes.  Each code row is m bytes read once and
// one float written, and the table (m KB) is read once; the work is m loads
// and adds per row, far below the FP32 and shared-memory rates.  At a graph
// search round (N ~ 100-140 rows, m = 48) there is almost no work at all:
// the launch and the host around it are the cost.
//
// Design, two paths (the wrapper picks by N, pq_adc.py::SMALL_N):
// * staged, for large N: the whole (m, 256) table is staged in dynamic
//   shared memory at block start: 48 KB at m = 48, 120 KB at m = 120 (a
//   block may use 227 KB, above 48 KB after
//   cudaFuncSetAttribute(MaxDynamicSharedMemorySize));
//   one thread per code row, grid-stride over the rows, with as many blocks
//   as fit on the SMs at once (fewer table copies than one block per 256 rows);
// * direct, for a search round's N ~ 100-140 rows (and up to a few thousand):
//   staging 48 KB on the one SM that holds all the rows costs more than the
//   lookups, so each thread
//   reads its row's m entries straight from the table (fresh in L2) through
//   the read-only cache, and 32-row blocks spread the rows over several SMs;
// * a row's bytes come in 4-byte loads when m % 4 == 0 and the codes are
//   4-byte aligned, byte by byte otherwise;
// * the sum is f32, in order j = 0 .. m-1, on both paths, so they give the
//   same bits.
// * host cost: the SM count, the occupancy per (variant, m) and the largest
//   dynamic shared memory set so far are cached per device, so a call is a
//   launch; cudaFuncSetAttribute runs only when a call needs more shared
//   memory than was set (an m = 120 call after m = 48 raises it).
// Later: several queries' tables per launch.
#include "cuda_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int DIRECT_THREADS = 32;  // rows a block on the direct path
constexpr int KSUB = 256;
constexpr int MAX_M = 227;          // the (m, 256) f32 table fits a block's 227 KB
constexpr int MAX_DEV = 64;

// A table entry: from shared memory (staged) or through the read-only cache.
template <bool LDG>
__device__ __forceinline__ float entry(const float* __restrict__ t, int i) {
  return LDG ? __ldg(t + i) : t[i];
}

template <bool VEC4, bool LDG>
__device__ __forceinline__ float row_sum(const uint8_t* __restrict__ row,
                                         const float* __restrict__ t, int m) {
  float acc = 0.f;
  if (VEC4) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
#pragma unroll 4
    for (int w = 0; w < m / 4; ++w) {
      const uint32_t v = words[w];
      const float* tw = t + 4 * w * KSUB;
      acc += entry<LDG>(tw, v & 0xffu);
      acc += entry<LDG>(tw, KSUB + ((v >> 8) & 0xffu));
      acc += entry<LDG>(tw, 2 * KSUB + ((v >> 16) & 0xffu));
      acc += entry<LDG>(tw, 3 * KSUB + (v >> 24));
    }
  } else {
    for (int j = 0; j < m; ++j) acc += entry<LDG>(t, j * KSUB + row[j]);
  }
  return acc;
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
adc_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ table,
                  float* __restrict__ out, long long N, int m) {
  extern __shared__ float lut[];              // (m, 256) f32
  for (int e = threadIdx.x; e < m * KSUB; e += THREADS) lut[e] = table[e];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long n = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       n < N; n += stride)
    out[n] = row_sum<VEC4, false>(codes + n * m, lut, m);
}

template <bool VEC4>
__global__ void __launch_bounds__(DIRECT_THREADS)
adc_direct_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ table,
                  float* __restrict__ out, long long N, int m) {
  const long long n = static_cast<long long>(blockIdx.x) * DIRECT_THREADS + threadIdx.x;
  if (n < N) out[n] = row_sum<VEC4, true>(codes + n * m, table, m);
}

// Per device: SM count (0 = not read yet), and per code-load variant the
// largest dynamic shared memory set so far and the resident blocks per m.
int g_sms[MAX_DEV];
int g_smem_set[2][MAX_DEV];
int g_per_sm[2][MAX_DEV][MAX_M + 1];

template <bool VEC4>
cudaError_t launch(const uint8_t* codes, const float* table, float* out, long long N, int m,
                   bool direct, int device, cudaStream_t stream) {
  if (direct) {
    const long long grid = (N + DIRECT_THREADS - 1) / DIRECT_THREADS;
    adc_direct_kernel<VEC4><<<static_cast<unsigned>(grid), DIRECT_THREADS, 0, stream>>>(
        codes, table, out, N, m);
    return cudaGetLastError();
  }
  const int smem = m * KSUB * static_cast<int>(sizeof(float));
  cudaError_t err;
  if (smem > g_smem_set[VEC4][device]) {
    err = cudaFuncSetAttribute(adc_kernel<VEC4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    g_smem_set[VEC4][device] = smem;
  }
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int& per_sm = g_per_sm[VEC4][device][m];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adc_kernel<VEC4>,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long need = (N + THREADS - 1) / THREADS;
  const long long fit = static_cast<long long>(g_sms[device]) * per_sm;
  const int grid = static_cast<int>(need < fit ? need : fit);
  adc_kernel<VEC4><<<grid, THREADS, smem, stream>>>(codes, table, out, N, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes (N, m) uint8 row-major, table (m, 256) f32, out (N,) f32, all on
// `device`, the current device; N >= 1, 1 <= m <= MAX_M.  direct: 1 for the
// direct path, 0 for the staged one.
int adc_lookup_u8(const void* codes, const void* table, void* out, long long N, int m,
                  int direct, int device, void* stream) {
  if (N < 1 || m < 1 || m > MAX_M || device < 0 || device >= MAX_DEV)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = m % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 4 == 0;
  return static_cast<int>(vec4 ? launch<true>(c, t, o, N, m, direct, device, s)
                               : launch<false>(c, t, o, N, m, direct, device, s));
}

}  // extern "C"
