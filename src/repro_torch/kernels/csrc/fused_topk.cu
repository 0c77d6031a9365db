// Fused squared-L2 + running top-k on Hopper: for each query, the k nearest
// database rows by (distance, id), without the (Q, N) matrix reaching memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_topk.py::l2_topk
// (body _fused_kernel), whose sequential N-axis grid steps carry each query
// block's running top-k in the output block.  Here a block owns a query block
// and a contiguous range of database rows and loops over that range itself.
//
// What bounds it on the H100: the product.  At the main path's closure step
// (4096 points x ~214k centroids x D=96, k=8) it is 2*Q*N*D = 168 GFLOP, 2.5 ms
// at the 67 TFLOP/s FP32 peak, against ~84 MB of input (25 us at 3.35 TB/s);
// the top-k upkeep is a compare per distance.  So it is bound by operations
// on the CUDA cores (exact f32 FMA: TF32 would miss the reference tolerance).
//
// Design (two instantiations of one kernel, the wrapper picks by Q, D and k):
// * wide: 128 queries x 128 rows a block, an 8x8 register tile a thread,
//   k <= 32, D <= 256, two blocks an SM; narrow: 32 queries x 256 rows, a
//   4x8 tile, k <= 128, any D (small batches, large k, GIST's 960).
// * the block's queries are staged once, at full depth, transposed to
//   [D][BQ] in shared memory, and stay resident while the block streams its
//   rows; x comes through a ring of STAGES depth slices (KC x BN, transposed
//   by 4-byte cp.async, one address step a copy), so the next slices load
//   while this one is multiplied.  Past MAXD (1024 in the narrow variant)
//   the queries no longer fit: their depth slices then come through the
//   ring beside x's (SQ, "streamed queries"), with the same FMA chain.
// * operands reach the registers as 128-bit shared loads: per depth step
//   the wide tile does 64 FMAs for 4 loads a thread.
// * |x|^2 is a pre-pass kernel over N (one launch of the same call), summed
//   sequentially over d; |q|^2 is the warp tree of the first port.  Each
//   distance is one FMA chain over d = 0 .. D-1 and fmaxf(qn + xn - 2 acc, 0),
//   so the distances are the first port's, bit for bit.
// * top-k upkeep: each query keeps a sorted list of (distance, id) in shared
//   memory.  A warp holds all of a query's rows of a tile (a warp is WM x GN
//   threads), so its lanes alone keep that query's list, with no block
//   barrier: threads filter their distances in registers against the list's
//   k-th entry, and the warp inserts the few survivors one by one.  Entries
//   compare by (distance, id), lower id first on ties, as the Pallas
//   kernel's min-extraction orders them; the list is the k smallest pairs
//   whatever the order of insertion.  The initial entries are (3.4e38, -1),
//   which is what a list keeps when k > N.
// * parallelism: a small Q (512 at the ground truth, 8 in batched_topk) gives
//   few query blocks for 132 SMs, so the wrapper splits the rows into S
//   contiguous ranges (grid.y).  Each block writes its range's sorted top-k,
//   and a merge kernel (a warp per query) takes the S lists by (distance,
//   id), which is exact: every member of the global top-k is in its own
//   range's top-k.
// * launch attributes: the dynamic shared memory (up to 227 KB) is raised
//   once per device and variant, only when a call needs more than was set.
#include "l2_common.cuh"

namespace {

using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 16;          // depth of one pipeline stage
constexpr int STAGES = 3;       // x slices in flight
constexpr int KMAX = 128;       // largest k
constexpr int MAX_SPLIT = 64;
constexpr int MAX_DEV = 64;
constexpr float BIG = 3.4e38f;

template <int BQ_, int BN_, int TM_, int TN_, int KMAXV_, int MAXD_, int MINB_>
struct Tile {
  static constexpr int BQ = BQ_;        // queries per block
  static constexpr int BN = BN_;        // rows per tile
  static constexpr int TM = TM_;        // queries per thread
  static constexpr int TN = TN_;        // rows per thread
  static constexpr int KMAXV = KMAXV_;  // largest k of this variant
  static constexpr int MAXD = MAXD_;    // largest D whose queries stay resident
  static constexpr int MIN_BLOCKS = MINB_;
  static constexpr int HM = TM / 4, HN = TN / 4;   // float4 groups a thread
  static constexpr int GM = BQ / TM, GN = BN / TN;
  static constexpr int WM = 32 / GN;    // a warp is WM x GN threads: all of a query's rows
  static constexpr int XS = BN + 4;     // padded row of a staged x slice (16-byte multiple)
  static_assert(GM * GN == THREADS && 32 % GN == 0 && GM == WARPS * WM, "thread grid");
  static_assert(TN <= 32 && KMAXV % 32 == 0, "masks and lists");
};
using Wide = Tile<128, 128, 8, 8, 32, 256, 2>;
using Narrow = Tile<32, 256, 4, 8, 128, 1024, 2>;

template <class T, bool SQ>
size_t smem_bytes(int D, int k) {
  const size_t Dp = static_cast<size_t>((D + KC - 1) / KC) * KC;
  const size_t qsz = SQ ? STAGES * KC : Dp;       // query depths held
  return sizeof(float) * (qsz * T::BQ + STAGES * (KC * T::XS + T::BN) + T::BQ
                          + 2 * static_cast<size_t>(T::BQ) * k);
}

__device__ __forceinline__ int gcd(int a, int b) {
  while (b) { const int t = a % b; a = b; b = t; }
  return a;
}

// (distance, id) order, lower id first on ties
__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// A warp inserts (cd, ci) into the sorted list (Ld, Li) of length k.
template <int KMAXV>
__device__ __forceinline__ void insert(float* Ld, int* Li, int k, float cd, int ci, int lane) {
  if (!before(cd, ci, Ld[k - 1], Li[k - 1])) return;     // warp-uniform
  int p = 0;
#pragma unroll
  for (int u = 0; u < KMAXV / 32; ++u) {
    const int t = lane + 32 * u;
    p += __popc(__ballot_sync(0xffffffffu, t < k && before(Ld[t], Li[t], cd, ci)));
  }
  float mv[KMAXV / 32];
  int mi[KMAXV / 32];
#pragma unroll
  for (int u = 0; u < KMAXV / 32; ++u) {
    const int t = lane + 32 * u;
    if (t >= p && t < k - 1) { mv[u] = Ld[t]; mi[u] = Li[t]; }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < KMAXV / 32; ++u) {
    const int t = lane + 32 * u;
    if (t >= p && t < k - 1) { Ld[t + 1] = mv[u]; Li[t + 1] = mi[u]; }
  }
  if (lane == 0) { Ld[p] = cd; Li[p] = ci; }
  __syncwarp();
}

// |x_n|^2, summed sequentially over d (a thread per row; 128 rows x 32
// depths staged at a time so the global reads are coalesced).
__global__ void __launch_bounds__(128)
row_norms_kernel(const float* __restrict__ x, float* __restrict__ out, int N, int D) {
  __shared__ float tile[128][33];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * 128;
  float norm = 0.f;
  for (int d0 = 0; d0 < D; d0 += 32) {
    for (int e = tid; e < 128 * 32; e += 128) {
      const int r = e / 32, c = e % 32;
      const int gr = r0 + r, gd = d0 + c;
      tile[r][c] = (gr < N && gd < D) ? x[static_cast<size_t>(gr) * D + gd] : 0.f;
    }
    __syncthreads();
    const int n = min(32, D - d0);
    for (int c = 0; c < n; ++c) norm = fmaf(tile[tid][c], tile[tid][c], norm);
    __syncthreads();
  }
  if (r0 + tid < N) out[r0 + tid] = norm;
}

template <class T, bool SQ>
__global__ void __launch_bounds__(THREADS, T::MIN_BLOCKS)
l2_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
               const float* __restrict__ xnorm, float* __restrict__ part_v,
               int* __restrict__ part_i, int Q, int N, int D, int k, int span) {
  extern __shared__ float4 smem4[];
  const int nK = (D + KC - 1) / KC, Dp = nK * KC;
  float* qs = reinterpret_cast<float*>(smem4);          // [Dp][BQ], SQ: [STAGES][KC][BQ]
  float* ring = qs + (SQ ? STAGES * KC : Dp) * T::BQ;    // [STAGES][KC][XS]
  float* xns = ring + STAGES * KC * T::XS;               // [STAGES][BN] row norms
  float* qn = xns + STAGES * T::BN;                      // [BQ]
  float* ld = qn + T::BQ;                                // [BQ][k] sorted lists
  int* li = reinterpret_cast<int*>(ld + T::BQ * k);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tm = warp * T::WM + lane / T::GN;            // thread's place in the grid
  const int tn = lane % T::GN;
  const int m0 = blockIdx.x * T::BQ;
  const int S = gridDim.y, s = blockIdx.y;
  const int lo = s * span;
  const int hi = min(N, lo + span);
  const int tiles = hi > lo ? (hi - lo + T::BN - 1) / T::BN : 0;
  const int iters = tiles * nK;
  // Tiles go in a strided order (stride coprime to the count, near 0.618 of
  // it): row ids that are clustered in space, as the closure's centroids
  // are, would otherwise improve each list in long bursts.  The lists do
  // not depend on the order.
  int stride = max(1, static_cast<int>(0.618f * tiles));
  while (gcd(stride, tiles) > 1) ++stride;

  // The load cursor walks the flat (tile, depth slice) sequence: slice
  // (ltile, lkc) goes to ring slot lslot, a tile's row norms with its first
  // slice to norm slot lnslot (the j-th tile's are read at its last slice,
  // before the (j + STAGES)-th tile's first is issued).  A thread copies
  // depth lc of rows lr, lr + LROWS, ...: one 64-bit address step a copy.
  constexpr int LROWS = THREADS / KC;
  const int lc = tid % KC, lr = tid / KC;
  const size_t lstep = static_cast<size_t>(LROWS) * D;
  int ltile = 0, lkc = 0, lslot = 0, lnslot = 0;
  auto load_next = [&]() {
    const int n0 = lo + ltile * T::BN, d0 = lkc * KC;
    const bool dok = d0 + lc < D;
    const float* src = x + static_cast<size_t>(n0 + lr) * D + d0 + lc;
    float* dst = ring + lslot * KC * T::XS + lc * T::XS + lr;
#pragma unroll
    for (int u = 0; u < T::BN / LROWS; ++u) {
      const bool ok = dok && n0 + lr + u * LROWS < hi;
      cp_async4(dst + u * LROWS, ok ? src + u * lstep : x, ok);
    }
    if (SQ)             // the block's queries at the same depths, [KC][BQ]
      for (int e = tid; e < KC * T::BQ; e += THREADS) {
        const int c = e % KC, r = e / KC;
        const bool ok = m0 + r < Q && d0 + c < D;
        cp_async4(qs + (lslot * KC + c) * T::BQ + r,
                  ok ? q + static_cast<size_t>(m0 + r) * D + d0 + c : q, ok);
      }
    if (lkc == 0)
      for (int r = tid; r < T::BN; r += THREADS)
        cp_async4(xns + lnslot * T::BN + r, n0 + r < hi ? xnorm + n0 + r : xnorm, n0 + r < hi);
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
    if (++lkc == nK) {
      lkc = 0;
      ltile += ltile + stride < tiles ? stride : stride - tiles;
      lnslot = lnslot + 1 == STAGES ? 0 : lnslot + 1;
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < iters) load_next();
    cp_async_commit();
  }

  if (!SQ)
    for (int e = tid; e < Dp * T::BQ; e += THREADS) {
      const int r = e % T::BQ, d = e / T::BQ;
      qs[e] = (m0 + r < Q && d < D) ? q[static_cast<size_t>(m0 + r) * D + d] : 0.f;
    }
  for (int r = warp; r < T::BQ; r += WARPS) {
    float sum = 0.f;
    if (m0 + r < Q)
      for (int t = lane; t < D; t += 32) {
        const float v = q[static_cast<size_t>(m0 + r) * D + t];
        sum = fmaf(v, v, sum);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) qn[r] = sum;
  }
  for (int e = tid; e < T::BQ * k; e += THREADS) { ld[e] = BIG; li[e] = -1; }
  __syncthreads();

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  int ctile = 0, ckc = 0, cslot = 0, cnslot = 0;    // the compute cursor
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // slice `it` landed; slice it-1's slot is free
    if (it + STAGES - 1 < iters) load_next();
    cp_async_commit();

    const float* xs = ring + cslot * KC * T::XS;
    const float* qk = qs + (SQ ? cslot : ckc) * KC * T::BQ;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int g = 0; g < T::HM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            qk + c * T::BQ + g * (T::BQ / T::HM) + 4 * tm);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < T::HN; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + c * T::XS + g * (T::BN / T::HN) + 4 * tn);
        b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    const int n0 = lo + ctile * T::BN, nslot = cnslot;
    cslot = cslot + 1 == STAGES ? 0 : cslot + 1;
    if (++ckc != nK) continue;
    ckc = 0;
    ctile += ctile + stride < tiles ? stride : stride - tiles;
    cnslot = cnslot + 1 == STAGES ? 0 : cnslot + 1;

    // ---- the tile is done: its distances against the top-k lists
    float xn[T::TN];
#pragma unroll
    for (int g = 0; g < T::HN; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(
          xns + nslot * T::BN + g * (T::BN / T::HN) + 4 * tn);
      xn[4 * g] = v.x; xn[4 * g + 1] = v.y; xn[4 * g + 2] = v.z; xn[4 * g + 3] = v.w;
    }
    // A query's rows of the tile all lie in one warp, whose lanes keep its
    // list: no block barrier.  Per query row of the thread tile, each lane
    // filters its distances against its query's k-th; the warp then walks
    // the survivors lane by lane and inserts each (insert() re-tests it
    // against the k-th as it is then, by (distance, id)).
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int r = (i / 4) * (T::BQ / T::HM) + 4 * tm + i % 4;
      const float qv = qn[r], td = ld[r * k + k - 1];
      unsigned hit = 0;           // fmaxf(v, 0) <= td iff v <= td, as td >= 0
#pragma unroll
      for (int j = 0; j < T::TN; ++j)
        if (fmaf(-2.f, acc[i][j], qv + xn[j]) <= td) hit |= 1u << j;
      if (n0 + T::BN > hi)        // the range's last tile: rows past its end
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          if (n0 + (j / 4) * (T::BN / T::HN) + 4 * tn + j % 4 >= hi) hit &= ~(1u << j);
      if (m0 + r >= Q) hit = 0;
      unsigned lanes = __ballot_sync(0xffffffffu, hit != 0);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        unsigned js = __shfl_sync(0xffffffffu, hit, src);
        const int rs = __shfl_sync(0xffffffffu, r, src);
        const int ns = n0 + 4 * (src % T::GN);
        while (js) {
          const int j = __ffs(js) - 1;
          js &= js - 1;
          float aj = acc[i][0], xj = xn[0];
#pragma unroll
          for (int jj = 1; jj < T::TN; ++jj) {
            aj = j == jj ? acc[i][jj] : aj;
            xj = j == jj ? xn[jj] : xj;
          }
          const float dj = __shfl_sync(0xffffffffu, fmaxf(fmaf(-2.f, aj, qv + xj), 0.f), src);
          insert<T::KMAXV>(ld + rs * k, li + rs * k, k, dj,
                           ns + (j / 4) * (T::BN / T::HN) + j % 4, lane);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int e = tid; e < T::BQ * k; e += THREADS) {
    const int r = e / k, j = e % k;
    if (m0 + r < Q) {
      const size_t o = (static_cast<size_t>(m0 + r) * S + s) * k + j;
      part_v[o] = ld[e];
      part_i[o] = li[e];
    }
  }
}

// A warp per query merges its S <= 64 sorted lists by (distance, id): lane
// l holds the heads of lists l and l + 32, and each of the k rounds takes
// the warp's least head (ties, which only the (3.4e38, -1) fill can make,
// go to the lower list) and advances that list.
__global__ void merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                             float* __restrict__ vals, int* __restrict__ ids, int Q, int S, int k) {
  const int gq = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (gq >= Q) return;
  const float* pv = part_v + static_cast<size_t>(gq) * S * k;
  const int* pi = part_i + static_cast<size_t>(gq) * S * k;
  const float inf = __int_as_float(0x7f800000);
  int h0 = 0, h1 = 0;                       // heads of lists lane, lane + 32
  float d0 = lane < S ? pv[lane * k] : inf, d1 = lane + 32 < S ? pv[(lane + 32) * k] : inf;
  int i0 = lane < S ? pi[lane * k] : 0x7fffffff, i1 = lane + 32 < S ? pi[(lane + 32) * k] : 0x7fffffff;
  for (int j = 0; j < k; ++j) {
    const bool second = before(d1, i1, d0, i0);
    float bd = second ? d1 : d0;
    int bi = second ? i1 : i0, owner = second ? lane + 32 : lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oo = __shfl_xor_sync(0xffffffffu, owner, off);
      if (before(od, oi, bd, bi) || (od == bd && oi == bi && oo < owner)) {
        bd = od; bi = oi; owner = oo;
      }
    }
    if (lane == 0) {
      vals[static_cast<size_t>(gq) * k + j] = bd;
      ids[static_cast<size_t>(gq) * k + j] = bi;
    }
    if (owner == lane) {
      ++h0;
      d0 = h0 < k ? pv[lane * k + h0] : inf;
      i0 = h0 < k ? pi[lane * k + h0] : 0x7fffffff;
    } else if (owner == lane + 32) {
      ++h1;
      d1 = h1 < k ? pv[(lane + 32) * k + h1] : inf;
      i1 = h1 < k ? pi[(lane + 32) * k + h1] : 0x7fffffff;
    }
  }
}

// Largest dynamic shared memory set so far, per instantiation (wide,
// narrow, narrow with streamed queries) and device.
size_t g_smem_set[3][MAX_DEV];

// Raise the kernel's dynamic shared-memory limit to `smem` if it is lower.
template <class T, bool SQ>
cudaError_t ensure_smem(int slot, int device, size_t smem) {
  if (smem <= g_smem_set[slot][device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      l2_topk_kernel<T, SQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) g_smem_set[slot][device] = smem;
  return err;
}

template <class T, bool SQ>
cudaError_t launch_main(const float* q, const float* x, const float* xn, float* pv, int* pi,
                        int Q, int N, int D, int k, int S, int span, int slot, int device,
                        cudaStream_t st) {
  const size_t smem = smem_bytes<T, SQ>(D, k);
  const cudaError_t err = ensure_smem<T, SQ>(slot, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + T::BQ - 1) / T::BQ, S);
  l2_topk_kernel<T, SQ><<<grid, THREADS, smem, st>>>(q, x, xn, pv, pi, Q, N, D, k, span);
  return cudaGetLastError();
}

template <class T, bool SQ>
cudaError_t blocks_per_sm(int slot, int device, int D, int k, int* out) {
  const size_t smem = smem_bytes<T, SQ>(D, k);
  const cudaError_t err = ensure_smem<T, SQ>(slot, device, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, l2_topk_kernel<T, SQ>, THREADS,
                                                       smem);
}

bool bad_args(int variant, int D, int k, int device) {
  const int kmax = variant == 0 ? Wide::KMAXV : Narrow::KMAXV;
  return variant < 0 || variant > 1 || k < 1 || k > kmax || D < 1 ||
         (variant == 0 && D > Wide::MAXD) || device < 0 || device >= MAX_DEV;
}

template <class T>
void tiles_of(int* v) {
  v[0] = T::BQ; v[1] = T::BN; v[2] = T::KMAXV; v[3] = T::MAXD; v[4] = T::MIN_BLOCKS;
}

}  // namespace

extern "C" {

// q (Q, D) and x (N, D) float32 on `device`; xnorm (N,) float32 scratch;
// vals/ids (Q, k).  With S > 1, part_v/part_i are (Q, S, k) scratch; with
// S == 1 they may alias vals/ids.  variant: 0 wide (D <= its MAXD), 1
// narrow (any D; past its MAXD the queries stream).  `device` is current.
int l2_topk_f32(const void* q, const void* x, void* xnorm, void* part_v, void* part_i,
                void* vals, void* ids, int Q, int N, int D, int k, int variant, int S,
                int span, int device, void* stream) {
  if (bad_args(variant, D, k, device) || S < 1 || S > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(x);
  auto* xn = static_cast<float*>(xnorm);
  if (N > 0) {
    row_norms_kernel<<<(N + 127) / 128, 128, 0, st>>>(xf, xn, N, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* pv = static_cast<float*>(S == 1 ? vals : part_v);
  auto* pi = static_cast<int*>(S == 1 ? ids : part_i);
  const cudaError_t err =
      variant == 0       ? launch_main<Wide, false>(qf, xf, xn, pv, pi, Q, N, D, k, S, span, 0,
                                                    device, st)
      : D <= Narrow::MAXD ? launch_main<Narrow, false>(qf, xf, xn, pv, pi, Q, N, D, k, S, span,
                                                      1, device, st)
                          : launch_main<Narrow, true>(qf, xf, xn, pv, pi, Q, N, D, k, S, span,
                                                     2, device, st);
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  merge_kernel<<<(Q + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<int*>(ids), Q, S, k);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the instantiation that a call of (variant, D,
// k) launches, at its dynamic shared memory (which may allow fewer than the
// __launch_bounds__ minimum); `device` is current.
int l2_topk_blocks_per_sm(int variant, int D, int k, int device, int* out) {
  if (bad_args(variant, D, k, device)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(variant == 0 ? blocks_per_sm<Wide, false>(0, device, D, k, out)
                          : D <= Narrow::MAXD ? blocks_per_sm<Narrow, false>(1, device, D, k, out)
                                              : blocks_per_sm<Narrow, true>(2, device, D, k, out));
}

// Tiles of a variant: block_q, block_n, k_max, max_d, blocks_per_sm (the
// __launch_bounds__ minimum); also the global k_max and max_split.
int l2_topk_tiles(int variant, int* tiles, int* kmax, int* max_split) {
  if (variant == 0) tiles_of<Wide>(tiles);
  else if (variant == 1) tiles_of<Narrow>(tiles);
  else return static_cast<int>(cudaErrorInvalidValue);
  *kmax = KMAX;
  *max_split = MAX_SPLIT;
  return 0;
}

}  // extern "C"
