// Squared-L2 distance matrix on Hopper: out[i, j] = |q_i|^2 + |x_j|^2 - 2 q_i.x_j
//
// Replaces the Pallas TPU kernel src/repro/kernels/distance.py::l2_distance
// (body _dist_kernel), whose (Q/BQ, N/BN, D/BD) grid carries the D-reduction
// in the output block across sequential grid steps.  Here the D-reduction is
// a loop inside each block: blocks run in parallel, in no order.
//
// What bounds it on the H100: at the port's main-path shape (the centroid
// probe, 512 queries x 214,790 centroids x D=96, f32) the work is 21.49 GFLOP
// (products, norms, combine), 0.3207 ms at the 67 TFLOP/s FP32 peak, against
// 522.6 MB (inputs once, the 440 MB output once), 0.156 ms at 3.35 TB/s: it
// is bound by operations on the CUDA cores, in exact f32 FMA (tensor cores
// would be TF32 and miss the f32 tolerance).
//
// Two instantiations; kernels/distance.py picks one by shape and dtype.
//
// * wide (f32, Q >= 128, 1 <= D <= 256; bf16 is widened to f32 by the
//   wrapper): 128 queries x 128 rows a tile, 256 threads, an 8x8 register
//   tile a thread, two blocks an SM.  A block keeps its 128 queries
//   resident in shared memory at full depth, transposed to [D][128], and
//   walks the row tiles of a contiguous range; x comes through a ring of
//   STAGES 16-deep slices (transposed by 4-byte cp.async), so the next
//   slices load while this one is multiplied.  Operands reach the registers
//   as 128-bit shared loads: per depth step a thread does 64 FMAs for 4
//   loads (the first port did 16 for 8 scalar loads, and shared-memory issue
//   set its pace).  The grid is (query blocks, row ranges) with the query
//   block fastest, so the blocks that read one x range run together and x
//   comes from HBM once and from L2 for the others; the wrapper sizes the
//   ranges so that the grid fills one wave at the occupancy of the call's
//   shared memory.  Each thread stores its rows as float4s (float2s or
//   scalars where a row of an N not divisible by 4 is not 16-byte aligned)
//   at columns 4*tn and 4*tn + 64, so a warp's row is 256 contiguous bytes.
//   (Streaming stores, __stcs, which keep the 440 MB output from competing
//   with x's tiles in L2, measured no faster on the H100 at the probe:
//   tools/l2_distance_variants.py times them, and the ring's depth and
//   stages.)  |x|^2 is summed from the ring's slices by the first 128
//   threads (16 FMAs a slice for half the warps, every query block of a
//   range again), which saves a second pass over x (82.5 MB at the probe)
//   and a launch.
// * simple (the first port's body: f32 below the wide shapes, int8 in exact
//   int32): one 256-thread block per 64x64 output tile, 16-deep slices
//   staged synchronously, a 4x4 register tile a thread, norms summed from
//   the staged slices.
//
// Bits: both run one fmaf chain a product over d = 0..D-1 from 0, the norms
// as sequential fmaf chains over d from the staged slices (the wide kernel:
// |q|^2 from its resident queries, |x|^2 by a thread per row of the tile as
// the slices pass through the ring), and fmaxf(|q|^2 + |x|^2 - 2 acc, 0),
// where 2 acc is exact: so the two give the same f32 bits.
#include "l2_common.cuh"

namespace {

using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int THREADS = 256;
constexpr int MAX_DEV = 64;

// ---------------------------------------------------------------- simple --

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // database rows per block
constexpr int BK = 16;    // depth slice staged per step

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
cudaError_t launch_simple(const T* q, const T* x, float* out, int Q, int N, int D,
                          cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  l2_distance_kernel<T><<<grid, THREADS, 0, st>>>(q, x, out, Q, N, D);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ wide --

struct Wide {
  static constexpr int BQ = 128;        // queries per block
  static constexpr int BN = 128;        // rows per tile
  static constexpr int TM = 8, TN = 8;  // a thread's register tile
  static constexpr int KC = 16;         // depth of one ring stage
  static constexpr int STAGES = 3;      // x slices in flight
  static constexpr int MAXD = 256;      // largest D whose queries stay resident
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int GN = BN / TN;    // threads across a tile's rows
  static constexpr int WM = 32 / GN;    // query groups a warp
  static constexpr int XS = BN + 4;     // padded row of a staged x slice (16-byte multiple)
  static constexpr int LROWS = THREADS / KC;
  static_assert((BQ / TM) * GN == THREADS && TM == 8 && TN == 8, "thread grid");
};

size_t wide_smem_bytes(int D) {
  using W = Wide;
  const size_t Dp = static_cast<size_t>((D + W::KC - 1) / W::KC) * W::KC;
  return sizeof(float) * (Dp * W::BQ + W::STAGES * W::KC * W::XS + W::BN + W::BQ);
}

// Four consecutive distances of one output row at column `col`; columns at
// or past `hi` belong to another range (or lie past N) and are not written.
__device__ __forceinline__ void store4(float* row, int col, int hi, float a, float b, float c,
                                       float d) {
  float* p = row + col;
  if (col + 4 <= hi) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    if ((addr & 15) == 0) {
      *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
      return;
    }
    if ((addr & 7) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
      *reinterpret_cast<float2*>(p + 2) = make_float2(c, d);
      return;
    }
  }
  if (col < hi) p[0] = a;
  if (col + 1 < hi) p[1] = b;
  if (col + 2 < hi) p[2] = c;
  if (col + 3 < hi) p[3] = d;
}

__global__ void __launch_bounds__(THREADS, Wide::MIN_BLOCKS)
l2_distance_wide_kernel(const float* __restrict__ q, const float* __restrict__ x,
                        float* __restrict__ out, int Q, int N, int D, int span) {
  constexpr int BQ = Wide::BQ, BN = Wide::BN, TM = Wide::TM, TN = Wide::TN, KC = Wide::KC,
                STAGES = Wide::STAGES, GN = Wide::GN, WM = Wide::WM, XS = Wide::XS,
                LROWS = Wide::LROWS;
  extern __shared__ float4 smem4[];
  const int nK = (D + KC - 1) / KC, Dp = nK * KC;
  float* qs = reinterpret_cast<float*>(smem4);   // [Dp][BQ]
  float* ring = qs + Dp * BQ;                    // [STAGES][KC][XS]
  float* xn_s = ring + STAGES * KC * XS;         // [BN] the tile's row norms
  float* qn = xn_s + BN;                         // [BQ]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tm = warp * WM + lane / GN;          // thread's place in the grid
  const int tn = lane % GN;
  const int m0 = blockIdx.x * BQ;
  const int lo = blockIdx.y * span;
  const int hi = min(N, lo + span);
  const int tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  const int iters = tiles * nK;

  // The load cursor walks the flat (tile, depth slice) sequence: slice
  // (ltile, lkc) goes to ring slot lslot.  A thread copies depth lc of rows
  // lr, lr + LROWS, ...: one 64-bit address step a copy.
  const int lc = tid % KC, lr = tid / KC;
  const size_t lstep = static_cast<size_t>(LROWS) * D;
  int ltile = 0, lkc = 0, lslot = 0;
  auto load_next = [&]() {
    const int n0 = lo + ltile * BN, d0 = lkc * KC;
    const bool dok = d0 + lc < D;
    const float* src = x + static_cast<size_t>(n0 + lr) * D + d0 + lc;
    float* dst = ring + lslot * KC * XS + lc * XS + lr;
#pragma unroll
    for (int u = 0; u < BN / LROWS; ++u) {
      const bool ok = dok && n0 + lr + u * LROWS < hi;
      cp_async4(dst + u * LROWS, ok ? src + u * lstep : x, ok);
    }
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
    if (++lkc == nK) {
      lkc = 0;
      ++ltile;
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < iters) load_next();
    cp_async_commit();
  }

  for (int e = tid; e < Dp * BQ; e += THREADS) {
    const int r = e % BQ, d = e / BQ;
    qs[e] = (m0 + r < Q && d < D) ? q[static_cast<size_t>(m0 + r) * D + d] : 0.f;
  }
  __syncthreads();
  if (tid < BQ) {     // |q|^2 in d order; read after the loop's first barrier
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qs[d * BQ + tid], qs[d * BQ + tid], s);
    qn[tid] = s;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xacc = 0.f;   // threads [0, BN): |x|^2 of the tile's row tid, in d order

  int ctile = 0, ckc = 0, cslot = 0;    // the compute cursor
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // slice `it` landed; slice it-1's slot is free
    if (it + STAGES - 1 < iters) load_next();
    cp_async_commit();

    const float* xs = ring + cslot * KC * XS;
    const float* qk = qs + ckc * KC * BQ;
    if (tid < BN)
#pragma unroll
      for (int c = 0; c < KC; ++c) xacc = fmaf(xs[c * XS + tid], xs[c * XS + tid], xacc);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(qk + c * BQ + 4 * tm);
      const float4 a1 = *reinterpret_cast<const float4*>(qk + c * BQ + BQ / 2 + 4 * tm);
      const float4 b0 = *reinterpret_cast<const float4*>(xs + c * XS + 4 * tn);
      const float4 b1 = *reinterpret_cast<const float4*>(xs + c * XS + BN / 2 + 4 * tn);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    const int n0 = lo + ctile * BN;
    cslot = cslot + 1 == STAGES ? 0 : cslot + 1;
    if (++ckc != nK) continue;
    ckc = 0;
    ++ctile;

    // ---- the tile is done: its distances to memory
    if (tid < BN) {
      xn_s[tid] = xacc;
      xacc = 0.f;
    }
    __syncthreads();    // (the next write of xn_s is a tile later, past a loop barrier)
    const float4 x0 = *reinterpret_cast<const float4*>(xn_s + 4 * tn);
    const float4 x1 = *reinterpret_cast<const float4*>(xn_s + BN / 2 + 4 * tn);
    const float xn[TN] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = (i / 4) * (BQ / 2) + 4 * tm + i % 4;
      if (m0 + r < Q) {
        const float qv = qn[r];
        float d[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) d[j] = fmaxf(fmaf(-2.f, acc[i][j], qv + xn[j]), 0.f);
        float* row = out + static_cast<size_t>(m0 + r) * N;
        store4(row, n0 + 4 * tn, hi, d[0], d[1], d[2], d[3]);
        store4(row, n0 + BN / 2 + 4 * tn, hi, d[4], d[5], d[6], d[7]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// Largest dynamic shared memory set so far for the wide kernel, per device.
size_t g_smem_set[MAX_DEV];

cudaError_t ensure_smem(int device, size_t smem) {
  if (smem <= g_smem_set[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      l2_distance_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) g_smem_set[device] = smem;
  return err;
}

bool bad_wide(int D, int device) {
  return D < 1 || D > Wide::MAXD || device < 0 || device >= MAX_DEV;
}

}  // namespace

extern "C" {

// q (Q, D) and x (N, D) float32, out (Q, N) float32, on `device` (current).
// variant 0, wide: the rows are S ranges of `span` (a multiple of 128) rows,
// S * span >= N.  variant 1, simple: S and span are not read.
int l2_distance_f32(const void* q, const void* x, void* out, int Q, int N, int D, int variant,
                    int S, int span, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  if (variant == 1) return static_cast<int>(launch_simple<float>(qf, xf, of, Q, N, D, st));
  if (variant != 0 || bad_wide(D, device) || S < 1 || span < 1 || span % Wide::BN != 0 ||
      static_cast<long long>(S) * span < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide_smem_bytes(D);
  const cudaError_t err = ensure_smem(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + Wide::BQ - 1) / Wide::BQ, S);
  l2_distance_wide_kernel<<<grid, THREADS, smem, st>>>(qf, xf, of, Q, N, D, span);
  return static_cast<int>(cudaGetLastError());
}

// int8 operands, exact in int32: the simple kernel.
int l2_distance_i8(const void* q, const void* x, void* out, int Q, int N, int D, void* stream) {
  return static_cast<int>(launch_simple<int8_t>(static_cast<const int8_t*>(q),
                                                static_cast<const int8_t*>(x),
                                                static_cast<float*>(out), Q, N, D,
                                                static_cast<cudaStream_t>(stream)));
}

// Resident wide blocks an SM at the dynamic shared memory of depth D (which
// may allow fewer than the __launch_bounds__ minimum); `device` is current.
int l2_distance_blocks_per_sm(int D, int device, int* out) {
  if (bad_wide(D, device)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide_smem_bytes(D);
  const cudaError_t err = ensure_smem(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, l2_distance_wide_kernel, THREADS, smem));
}

// Tiles: wide block_q, block_n, max_d, blocks_per_sm (the __launch_bounds__
// minimum), then simple block_q, block_n.
int l2_distance_tiles(int* tiles) {
  tiles[0] = Wide::BQ; tiles[1] = Wide::BN; tiles[2] = Wide::MAXD; tiles[3] = Wide::MIN_BLOCKS;
  tiles[4] = BM; tiles[5] = BN;
  return 0;
}

}  // extern "C"
