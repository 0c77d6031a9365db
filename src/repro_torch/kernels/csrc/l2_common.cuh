// Shared pieces of the port's squared-L2 kernels (sm_90a): the simple
// l2_distance body's slice staging, and the 4-byte cp.async copies through
// which the wide l2_distance kernel and fused_topk.cu stream their rows.
//
// Both kernels compute d = |q|^2 + |x|^2 - 2 q.x over row-major operands on
// the CUDA cores in exact float32 FMA (or exact int32 for int8), never TF32:
// the reference's tolerances (rtol 1e-5 f32) are below what TF32 keeps.
#pragma once

#include "cuda_common.cuh"

#include <type_traits>

namespace repro {

// Accumulator type per input type: int8 accumulates exactly in int32.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ int widen(int8_t v) { return static_cast<int>(v); }

// Load a (ROWS x BK) slice of a row-major (n_rows, D) operand into shared
// memory, transposed to [BK][ROWS + 1] so the inner product reads rows
// with unit stride.  Out-of-range rows and depths load as zero, which adds
// nothing to a product or a norm.
template <int ROWS, int BK, int THREADS, typename T, typename A>
__device__ __forceinline__ void load_slice(A (*dst)[ROWS + 1], const T* __restrict__ src,
                                           int row0, int n_rows, int k0, int D) {
  for (int e = threadIdx.x; e < ROWS * BK; e += THREADS) {
    const int r = e / BK, c = e % BK;
    const int gr = row0 + r, gk = k0 + c;
    dst[c][r] = (gr < n_rows && gk < D) ? widen(src[static_cast<size_t>(gr) * D + gk]) : A(0);
  }
}

// One 4-byte asynchronous copy global -> shared; with !ok the destination is
// zero-filled and `src` is not read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

}  // namespace repro
