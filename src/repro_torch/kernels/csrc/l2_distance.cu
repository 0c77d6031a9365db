// Squared-L2 distance matrix on Hopper: out[i, j] = |q_i|^2 + |x_j|^2 - 2 q_i.x_j
//
// Replaces the Pallas TPU kernel src/repro/kernels/distance.py::l2_distance
// (body _dist_kernel), whose (Q/BQ, N/BN, D/BD) grid carries the D-reduction
// in the output block across sequential grid steps.  Here the D-reduction is
// a loop inside each block: blocks run in parallel, in no order.
//
// What bounds it on the H100: at the port's main-path shape (the centroid
// probe, 512 queries x ~214k centroids x D=96, f32) the product is 2*Q*N*D
// = 21 GFLOP, 0.31 ms at the 67 TFLOP/s FP32 peak, against 0.13 ms to write
// the 438 MB output at 3.35 TB/s: it is bound by operations on the CUDA
// cores (tensor cores would be TF32 and miss the f32 tolerance).
//
// Design: one 256-thread block per 64x64 output tile; depth slices of 16
// are staged in shared memory, transposed so a thread's operands come at
// unit stride; each thread keeps a 4x4 register tile (rows ty+16i, cols
// tx+16j, so a warp's stores are 16 consecutive floats).  The norms are
// summed from the same staged slices by 128 of the threads, so the kernel
// is one pass over q and x and writes each output once.  This simple SIMT
// form reaches a fraction of the FP32 peak (shared-memory loads per FMA are
// the limit); a wider register tile and TMA staging are the next step.
#include "l2_common.cuh"

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // database rows per block
constexpr int BK = 16;    // depth slice staged per step
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
l2_distance_kernel(const T* __restrict__ q, const T* __restrict__ x,
                   float* __restrict__ out, int Q, int N, int D) {
  using A = typename repro::AccOf<T>::type;
  __shared__ A qs[BK][BM + 1];
  __shared__ A xs[BK][BN + 1];
  __shared__ A qn[BM];
  __shared__ A xn[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  A acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = A(0);
  A norm = A(0);   // threads [0, BM) own a query norm, [BM, BM+BN) a row norm

  for (int k0 = 0; k0 < D; k0 += BK) {
    repro::load_slice<BM, BK, THREADS>(qs, q, m0, Q, k0, D);
    repro::load_slice<BN, BK, THREADS>(xs, x, n0, N, k0, D);
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int c = 0; c < BK; ++c) norm += qs[c][tid] * qs[c][tid];
    } else if (tid < BM + BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c) norm += xs[c][tid - BM] * xs[c][tid - BM];
    }
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      A a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  if (tid < BM) qn[tid] = norm;
  else if (tid < BM + BN) xn[tid - BM] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, gm = m0 + r;
    if (gm >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, gn = n0 + c;
      if (gn >= N) continue;
      const A d = qn[r] + xn[c] - A(2) * acc[i][j];
      // floats are clamped at 0 (rounding can go below); int8 is exact
      out[static_cast<size_t>(gm) * N + gn] =
          std::is_same<A, int>::value ? static_cast<float>(d) : fmaxf(static_cast<float>(d), 0.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* x, void* out, int Q, int N, int D, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  l2_distance_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<float*>(out), Q, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int l2_distance_f32(const void* q, const void* x, void* out, int Q, int N, int D, void* stream) {
  return launch<float>(q, x, out, Q, N, D, stream);
}

int l2_distance_bf16(const void* q, const void* x, void* out, int Q, int N, int D, void* stream) {
  return launch<__nv_bfloat16>(q, x, out, Q, N, D, stream);
}

int l2_distance_i8(const void* q, const void* x, void* out, int Q, int N, int D, void* stream) {
  return launch<int8_t>(q, x, out, Q, N, D, stream);
}

}  // extern "C"
