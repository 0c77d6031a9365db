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
// Design:
// * distance tiles: 32 queries x 64 rows per step, depth staged through shared
//   memory in slices of 16, each of 256 threads holding a 2x4 register tile;
//   the tile lands in shared memory, clamped at 0 as the reference clamps.
// * top-k upkeep: each warp owns 4 queries and keeps each one's sorted list of
//   (distance, id) in shared memory (k <= 128).  A ballot against the current
//   k-th distance filters a tile's 64 candidates; the rare survivors are
//   inserted in id order.  Rows arrive in increasing id, so a survivor sorts
//   after every kept entry of equal distance: the list stays in exact
//   (distance, id) order, lower id first on ties, as the Pallas kernel's
//   min-extraction gives it.  The initial entries are (3.4e38, -1), which is
//   what a list keeps when k > N.
// * parallelism: a small Q (512 at the ground truth, 8 in batched_topk) gives
//   few query blocks for 132 SMs, so the wrapper splits the rows into S
//   contiguous ranges (grid.y).  Each block writes its range's sorted top-k,
//   and a second kernel merges the S lists per query by (distance, id), which
//   is exact: every member of the global top-k is in its own range's top-k.
#include "l2_common.cuh"

namespace {

constexpr int BQ = 32;       // queries per block
constexpr int BN = 64;       // database rows per tile
constexpr int BK = 16;       // depth slice staged per step
constexpr int KMAX = 128;    // largest k
constexpr int MAX_SPLIT = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 3.4e38f;

__global__ void __launch_bounds__(THREADS, 4)
l2_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
               float* __restrict__ part_v, int* __restrict__ part_i,
               int Q, int N, int D, int k, int span) {
  __shared__ float qs[BK][BQ + 1];
  __shared__ float xs[BK][BN + 1];
  __shared__ float dist[BQ][BN + 1];
  __shared__ float qn[BQ];
  __shared__ float xn[BN];
  __shared__ float best_d[BQ][KMAX];
  __shared__ int best_i[BQ][KMAX];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;   // register tile: rows ty+16i, cols tx+16j
  const int m0 = blockIdx.x * BQ;
  const int S = gridDim.y, s = blockIdx.y;
  const int lo = s * span;
  const int hi = min(N, lo + span);

  for (int e = tid; e < BQ * KMAX; e += THREADS) {
    best_d[e / KMAX][e % KMAX] = BIG;
    best_i[e / KMAX][e % KMAX] = -1;
  }
  for (int r = warp; r < BQ; r += WARPS) {
    float sum = 0.f;
    if (m0 + r < Q)
      for (int t = lane; t < D; t += 32) {
        const float v = q[static_cast<size_t>(m0 + r) * D + t];
        sum += v * v;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) qn[r] = sum;
  }
  __syncthreads();

  for (int n0 = lo; n0 < hi; n0 += BN) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float norm = 0.f;   // threads [0, BN) own the norm of row n0 + tid

    for (int k0 = 0; k0 < D; k0 += BK) {
      repro::load_slice<BQ, BK, THREADS>(qs, q, m0, Q, k0, D);
      repro::load_slice<BN, BK, THREADS>(xs, x, n0, hi, k0, D);
      __syncthreads();
      if (tid < BN) {
#pragma unroll
        for (int c = 0; c < BK; ++c) norm += xs[c][tid] * xs[c][tid];
      }
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        float a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = qs[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
    if (tid < BN) xn[tid] = norm;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        dist[r][c] = fmaxf(qn[r] + xn[c] - 2.f * acc[i][j], 0.f);
      }
    __syncthreads();

    for (int r = warp; r < BQ && m0 + r < Q; r += WARPS) {
      float* bd = best_d[r];
      int* bi = best_i[r];
      for (int c0 = 0; c0 < BN && n0 + c0 < hi; c0 += 32) {
        const float d = dist[r][c0 + lane];
        unsigned mask = __ballot_sync(0xffffffffu, n0 + c0 + lane < hi && d < bd[k - 1]);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float cd = __shfl_sync(0xffffffffu, d, src);
          if (!(cd < bd[k - 1])) continue;   // the k-th fell since the ballot
          // kept entries <= cd have smaller ids, so they stay ahead
          int p = 0;
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int t = lane + 32 * u;
            p += __popc(__ballot_sync(0xffffffffu, t < k && bd[t] <= cd));
          }
          float mv[KMAX / 32];
          int mi[KMAX / 32];
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int t = lane + 32 * u;
            if (t >= p && t < k - 1) { mv[u] = bd[t]; mi[u] = bi[t]; }
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < KMAX / 32; ++u) {
            const int t = lane + 32 * u;
            if (t >= p && t < k - 1) { bd[t + 1] = mv[u]; bi[t + 1] = mi[u]; }
          }
          if (lane == 0) { bd[p] = cd; bi[p] = n0 + c0 + src; }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * k; e += THREADS) {
    const int r = e / k, j = e % k;
    if (m0 + r < Q) {
      const size_t o = (static_cast<size_t>(m0 + r) * S + s) * k + j;
      part_v[o] = best_d[r][j];
      part_i[o] = best_i[r][j];
    }
  }
}

// One thread per query: merge its S sorted lists by (distance, id).
__global__ void merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                             float* __restrict__ vals, int* __restrict__ ids, int Q, int S, int k) {
  const int gq = blockIdx.x * blockDim.x + threadIdx.x;
  if (gq >= Q) return;
  const float* pv = part_v + static_cast<size_t>(gq) * S * k;
  const int* pi = part_i + static_cast<size_t>(gq) * S * k;
  int head[MAX_SPLIT];
  for (int s = 0; s < S; ++s) head[s] = 0;
  for (int j = 0; j < k; ++j) {
    int best = -1;
    float bd = 0.f;
    int bi = 0;
    for (int s = 0; s < S; ++s) {
      if (head[s] >= k) continue;
      const float d = pv[s * k + head[s]];
      const int i = pi[s * k + head[s]];
      if (best < 0 || d < bd || (d == bd && i < bi)) { best = s; bd = d; bi = i; }
    }
    vals[static_cast<size_t>(gq) * k + j] = bd;
    ids[static_cast<size_t>(gq) * k + j] = bi;
    ++head[best];
  }
}

}  // namespace

extern "C" {

// q (Q, D) and x (N, D) float32; vals/ids (Q, k).  With S > 1, part_v/part_i
// are (Q, S, k) scratch; with S == 1 they may alias vals/ids.
int l2_topk_f32(const void* q, const void* x, void* part_v, void* part_i, void* vals, void* ids,
                int Q, int N, int D, int k, int S, int span, void* stream) {
  if (k < 1 || k > KMAX || S < 1 || S > MAX_SPLIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + BQ - 1) / BQ, S);
  l2_topk_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(S == 1 ? vals : part_v), static_cast<int*>(S == 1 ? ids : part_i),
      Q, N, D, k, span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  merge_kernel<<<(Q + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<int*>(ids), Q, S, k);
  return static_cast<int>(cudaGetLastError());
}

int l2_topk_tiles(int* bq, int* bn, int* kmax, int* max_split) {
  *bq = BQ;
  *bn = BN;
  *kmax = KMAX;
  *max_split = MAX_SPLIT;
  return 0;
}

}  // extern "C"
