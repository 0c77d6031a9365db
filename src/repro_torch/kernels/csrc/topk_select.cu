// Stable top-k selection on Hopper: for each row of a (R, N) float32 matrix,
// the k smallest values in ascending order with their int64 indices, lower
// index first on ties -- what kernels/ref.py::stable_topk_smallest (a full
// stable torch.sort, then the first k) returns, bit for bit.
//
// Replaces no TPU kernel: the reference's top-k is jax.lax.top_k, which XLA
// compiles.  It was added because the stable sort was most of the device
// search's card time (the probe's select over ~19.7k centroids a query).
//
// What bounds it on the H100: reading the matrix once.  At the probe (500 x
// ~19.7k, k 16) that is 39.4 MB, ~12 us at 3.35 TB/s, and l2_distance has
// just written it into the 50 MB L2.  Nothing is a floating-point product.
//
// Design (one kernel, one launch a call; the wrapper's plan sets its shape
// from N and k alone):
// * one block a row, of 32 to 1024 threads (about 8 elements a thread, at
//   least k threads): a short row (the merge's 40-wide one) is one warp.
// * each value maps to an order-preserving uint32 key, the order of the
//   card's stable sort: -0.0 ties +0.0, a NaN sits by its bits (above +inf,
//   or below -inf with the sign bit set).
// * the row is read as 16-byte quads from its aligned start below, so any
//   row start and any N take the vector path; only the first and the last
//   quad mask positions outside the row.  The keys are staged in shared
//   memory when the row fits (~56k columns; two such blocks an SM at the
//   probe's 19.7k); a longer row is read again by each pass.
// * the read that stages the keys also builds the histogram of their top
//   bits (11 at 1024 threads: sign, exponent, two mantissa bits), each
//   thread adding a run of
//   equal digits in one shared atomic; a block scan finds the digit where the
//   k-th key lies.  Radix select goes on, a digit of the next bits at a time,
//   only while the keys at or below the prefix overflow the candidate buffer
//   (2k + 64) and the prefix is not the whole key: on the probe's distances
//   one digit is enough for most rows.
// * candidates: when those at or below the prefix fit, one compare a key
//   against the prefix's upper bound, warp-aggregated slots; else (the whole
//   key, too many ties) the keys below it anywhere and the first `take` equal
//   to it by index, through a block-wide prefix over the tie flags tile by
//   tile.  Each candidate's rank among them by (key, index) is its place:
//   the first k are written, values read back from the row (so the bits of
//   -0.0 and of a NaN are the input's).  A row that fits the buffer whole
//   skips straight to the candidates.
// * no global scratch; the outputs are the wrapper's torch.empty; the
//   dynamic shared memory (up to the device's opt-in limit) is raised once a
//   device and variant when a call needs more than was set.
#include "cuda_common.cuh"

namespace {

// What the kernel itself takes; the plan within it (k's limit, the digit's
// width, the buffer's slack) is the wrapper's, topk_select.py.
constexpr int MAX_THREADS = 1024;  // CUDA's most threads a block
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_BITS = 16;       // a histogram of at most 2^16 bins
constexpr int MAX_DEV = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Shared {
  uint32_t warp[MAX_WARPS];
  uint32_t sel_bin, sel_before, sel_count;
  uint32_t below_pos, tie_base, done;
};

// Order-preserving key of a float, in the order the card's stable sort
// (a radix sort of the bits) gives: -0.0 ties +0.0, and a NaN sits by its
// bits, below -inf with the sign bit set and above +inf without it.
__device__ __forceinline__ uint32_t to_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;                     // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint4 to_keys(float4 v) {
  return make_uint4(to_key(v.x), to_key(v.y), to_key(v.z), to_key(v.w));
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// The row as 16-byte quads: quad q holds elements 4q - a .. 4q - a + 3,
// where a is the row's start modulo four floats; only the first and the
// last quad hold positions outside [0, N) (the 16-byte segments they read
// lie in the row's own pages).
struct Quads {
  const float4* g;     // the row's quads in memory
  uint4* s;            // their keys in shared memory, when staged
  int a, n, N;

  __device__ __forceinline__ bool edge(int q) const { return q == 0 || q == n - 1; }
  __device__ __forceinline__ bool valid(int q, int c) const {
    return static_cast<unsigned>(4 * q + c - a) < static_cast<unsigned>(N);
  }
  template <bool STAGED>
  __device__ __forceinline__ uint4 keys(int q) const {
    return STAGED ? s[q] : to_keys(__ldg(g + q));
  }
};

__device__ __forceinline__ uint32_t lane_of(uint4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Adds one digit to a thread's run of equal digits, flushing the run to the
// histogram when the digit changes.
__device__ __forceinline__ void count(uint32_t* hist, uint32_t d, uint32_t& cur,
                                      uint32_t& run) {
  if (run && d != cur) {
    atomicAdd(hist + cur, run);
    run = 0u;
  }
  cur = d;
  ++run;
}

// After a histogram of `nb` bins of the next `w` bits: the bin where the
// (k - less)-th key lies.  The keys below it join `less`, those in it become
// `at`, and the prefix takes its bits.  Ends in a barrier.
__device__ void pick_bin(const uint32_t* hist, uint32_t nb, int w, int k, Shared& sh,
                         int& less, int& at, uint32_t& prefix, int& shift) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const uint32_t need = static_cast<uint32_t>(k - less);
  const uint32_t per = (nb + T - 1) / T;
  const uint32_t b0 = min(nb, tid * per), b1 = min(nb, b0 + per);
  uint32_t mine = 0u;
  for (uint32_t b = b0; b < b1; ++b) mine += hist[b];
  const uint32_t inc = warp_inclusive(mine, lane);
  if (lane == 31) sh.warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t v = warp_inclusive(lane < nw ? sh.warp[lane] : 0u, lane);
    if (lane < nw) sh.warp[lane] = v;
  }
  __syncthreads();
  uint32_t before = (warp ? sh.warp[warp - 1] : 0u) + inc - mine;
  for (uint32_t b = b0; b < b1; ++b) {
    const uint32_t h = hist[b];
    if (before < need && need <= before + h) {
      sh.sel_bin = b;
      sh.sel_before = before;
      sh.sel_count = h;
    }
    before += h;
  }
  __syncthreads();
  less += static_cast<int>(sh.sel_before);
  at = static_cast<int>(sh.sel_count);
  prefix = (prefix << w) | sh.sel_bin;       // the prefix is 0 before the first digit
  shift -= w;
  __syncthreads();            // sel_* and sh.warp are read before the next pass
}

template <bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS, 2)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ vals,
                   int64_t* __restrict__ idx, int N, int k, int bits, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* hist = reinterpret_cast<uint32_t*>(smem);                    // 1 << bits
  auto* staged = reinterpret_cast<uint4*>(hist + (1u << bits));      // (N + 6) / 4, staged
  auto* cand = reinterpret_cast<uint64_t*>(staged + (STAGED ? (N + 6) / 4 : 0));  // cap
  __shared__ Shared sh;
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  const float* row = x + static_cast<size_t>(blockIdx.x) * N;
  const int a = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3u);
  const Quads rq{reinterpret_cast<const float4*>(row - a), staged, a, (N + a + 3) >> 2, N};

  // 1. one read of the row: its keys (staged) and the histogram of their
  // top `bits` bits (a row that fits the buffer whole needs neither)
  int shift = 32, less = 0, at = N;
  uint32_t prefix = 0u;
  if (N > cap) {
    for (uint32_t b = tid; b < (1u << bits); b += T) hist[b] = 0u;
    __syncthreads();
    const int low = 32 - bits;
    uint32_t cur = 0u, run = 0u;
    for (int q = tid; q < rq.n; q += T) {
      const uint4 kq = to_keys(__ldg(rq.g + q));
      if (STAGED) rq.s[q] = kq;
      const bool edge = rq.edge(q);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!edge || rq.valid(q, c)) count(hist, lane_of(kq, c) >> low, cur, run);
    }
    if (run) atomicAdd(hist + cur, run);
    __syncthreads();
    pick_bin(hist, 1u << bits, bits, k, sh, less, at, prefix, shift);
  }

  // 2. radix select: `less` keys lie below the prefix, `at` keys share it,
  // and the k-th is among the latter; a digit more until those at or below
  // the prefix fit the buffer, or the prefix is the whole key
  while (shift > 0 && less + at > cap) {
    const int w = min(bits, shift), low = shift - w;
    const uint32_t nb = 1u << w;
    for (uint32_t b = tid; b < nb; b += T) hist[b] = 0u;
    __syncthreads();
    uint32_t cur = 0u, run = 0u;
    for (int q = tid; q < rq.n; q += T) {
      const uint4 kq = rq.keys<STAGED>(q);
      const bool edge = rq.edge(q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t key = lane_of(kq, c);
        if ((key >> shift) == prefix && (!edge || rq.valid(q, c)))
          count(hist, (key >> low) & (nb - 1u), cur, run);
      }
    }
    if (run) atomicAdd(hist + cur, run);
    __syncthreads();
    pick_bin(hist, nb, w, k, sh, less, at, prefix, shift);
  }

  // 3. candidates: when those at or below the prefix fit, all of them (in
  // any order: the rank below orders them); else the prefix is the whole
  // key, and the keys below it go anywhere in [0, less), the first `take`
  // of those equal to it by index after them
  const bool all = less + at <= cap;
  const int take = all ? at : k - less;
  const int M = less + take;
  if (tid == 0) {
    sh.below_pos = 0u;
    sh.tie_base = 0u;
    sh.done = 0u;
  }
  __syncthreads();
  auto put = [&](bool below, uint32_t key, int i) {
    const uint32_t bm = __ballot_sync(FULL, below);
    if (bm) {
      const int leader = __ffs(bm) - 1;
      uint32_t slot = 0u;
      if (lane == leader) slot = atomicAdd(&sh.below_pos, __popc(bm));
      slot = __shfl_sync(FULL, slot, leader) + __popc(bm & lanes_below);
      if (below) cand[slot] = (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(i);
    }
  };
  if (all) {
    const uint32_t bound = shift >= 32 ? 0xffffffffu : (prefix << shift) | ((1u << shift) - 1u);
    for (int base = 0; base < rq.n; base += T) {
      const int q = base + tid;
      uint4 kq = make_uint4(0u, 0u, 0u, 0u);
      bool in[4] = {false, false, false, false};
      if (q < rq.n) {
        kq = rq.keys<STAGED>(q);
        const bool edge = rq.edge(q);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          in[c] = lane_of(kq, c) <= bound && (!edge || rq.valid(q, c));
      }
      if (__any_sync(FULL, in[0] || in[1] || in[2] || in[3])) {
#pragma unroll
        for (int c = 0; c < 4; ++c) put(in[c], lane_of(kq, c), 4 * q + c - a);
      }
    }
  } else {
    const auto* keys = reinterpret_cast<const uint32_t*>(rq.s);
    for (int base = 0; base < N; base += T) {
      const int i = base + tid;
      uint32_t key = 0u;
      bool below = false, tie = false;
      if (i < N) {
        key = STAGED ? keys[i + a] : to_key(__ldg(row + i));
        below = key < prefix;
        tie = key == prefix;
      }
      put(below, key, i);
      const uint32_t tm = __ballot_sync(FULL, tie);
      if (lane == 0) sh.warp[warp] = __popc(tm);
      __syncthreads();
      uint32_t r = sh.tie_base + __popc(tm & lanes_below);
      for (int v = 0; v < warp; ++v) r += sh.warp[v];
      if (tie && r < static_cast<uint32_t>(take))
        cand[less + r] = (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(i);
      __syncthreads();
      if (tid == 0) {
        for (int v = 0; v < nw; ++v) sh.tie_base += sh.warp[v];
        sh.done = sh.tie_base >= static_cast<uint32_t>(take) &&
                  sh.below_pos == static_cast<uint32_t>(less);
      }
      __syncthreads();
      if (sh.done) break;
    }
  }
  __syncthreads();

  // 4. each candidate's rank by (key, index) is its place among the first k
  float* vout = vals + static_cast<size_t>(blockIdx.x) * k;
  int64_t* iout = idx + static_cast<size_t>(blockIdx.x) * k;
  for (int c = tid; c < M; c += T) {
    const uint64_t me = cand[c];
    int r = 0;
    for (int j = 0; j < M; ++j) r += cand[j] < me;
    if (r < k) {
      const uint32_t i = static_cast<uint32_t>(me);
      vout[r] = __ldg(row + i);
      iout[r] = static_cast<int64_t>(i);
    }
  }
}

int g_optin[MAX_DEV];
int g_smem_set[2][MAX_DEV];

// Shared memory besides the staged keys: the histogram and the candidates.
size_t base_bytes(int bits, int cap) {
  return static_cast<size_t>(cap) * sizeof(uint64_t) + (sizeof(uint32_t) << bits);
}

cudaError_t optin_bytes(int device, int* out) {
  if (g_optin[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &g_optin[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
  }
  *out = g_optin[device];
  return cudaSuccess;
}

// The longest row whose keys stay in shared memory beside the buffers.
cudaError_t max_staged(int bits, int cap, int device, long long* out) {
  int optin;
  const cudaError_t err = optin_bytes(device, &optin);
  if (err != cudaSuccess) return err;
  const long long room = static_cast<long long>(optin) - static_cast<long long>(sizeof(Shared)) -
                         static_cast<long long>(base_bytes(bits, cap));
  // the staged quads hold up to N + 6 keys (the row's start and end quads)
  *out = room > 0 ? room / static_cast<long long>(sizeof(uint32_t)) - 6 : 0;
  return cudaSuccess;
}

template <bool STAGED>
cudaError_t launch(const float* x, float* vals, int64_t* idx, long long R, int N, int k,
                   int threads, int bits, int cap, int device, cudaStream_t stream) {
  const size_t smem = base_bytes(bits, cap) + (STAGED ? sizeof(uint4) * ((N + 6) / 4) : 0);
  if (static_cast<int>(smem) > g_smem_set[STAGED][device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    g_smem_set[STAGED][device] = static_cast<int>(smem);
  }
  topk_select_kernel<STAGED><<<static_cast<unsigned>(R), threads, smem, stream>>>(
      x, vals, idx, N, k, bits, cap);
  return cudaGetLastError();
}

// A buffer too large for shared memory fails when the launch sets it.
bool bad_plan(int N, int k, int threads, int bits, int cap, int device) {
  return N < 1 || k < 1 || k > N || threads < 32 || threads > MAX_THREADS ||
         (threads & (threads - 1)) != 0 || bits < 1 || bits > MAX_BITS || cap < k ||
         cap > N || device < 0 || device >= MAX_DEV;
}

}  // namespace

extern "C" {

// The longest row kept in shared memory at a plan's digit bits and
// candidate buffer on `device`.
int topk_select_max_staged(int bits, int cap, int device, long long* out) {
  if (bits < 1 || bits > MAX_BITS || cap < 1 || device < 0 || device >= MAX_DEV)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(max_staged(bits, cap, device, out));
}

// x (R, N) float32 row-major; vals (R, k) float32 and idx (R, k) int64, all
// on `device`, the current device.  threads, bits and cap are the wrapper's
// plan: a power of two in [32, 1024], the digit width (at most 16 bits), the
// candidate buffer (k <= cap <= N).
int topk_select_f32(const void* x, void* vals, void* idx, long long R, int N, int k,
                    int threads, int bits, int cap, int device, void* stream) {
  if (R < 1 || R > 0x7fffffffLL || bad_plan(N, k, threads, bits, cap, device))
    return static_cast<int>(cudaErrorInvalidValue);
  long long staged_n;
  const cudaError_t err = max_staged(bits, cap, device, &staged_n);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xf = static_cast<const float*>(x);
  auto* vf = static_cast<float*>(vals);
  auto* il = static_cast<int64_t*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  // a row that fits the candidate buffer is read once, in place
  return static_cast<int>(
      N > cap && N <= staged_n ? launch<true>(xf, vf, il, R, N, k, threads, bits, cap, device, st)
                    : launch<false>(xf, vf, il, R, N, k, threads, bits, cap, device, st));
}

}  // extern "C"
