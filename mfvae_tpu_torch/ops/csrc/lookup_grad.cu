// Hopper (sm_90a) kernel K4: the backward of the MAVAE's embedding lookups
// by position.  Plain C entry point, bound from Python with ctypes
// (mfvae_tpu_torch/ops/lookup_grad.py).  It launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// K4 replaces no TPU kernel: the JAX package leaves its lookups to XLA.
// It replaces PyTorch's backward of advanced indexing
// (indexing_backward_kernel: index_put_(accumulate=True) after a radix
// sort of the indices, and before it the cast of the bf16 gradient to an
// f32 copy).  That kernel gives each distinct table row to one warp, which
// walks the row's duplicates in order, so a table of 40 or 200 rows keeps
// a few dozen warps busy, each thousands of rows deep: on an H100, 5.7 ms
// of a b4,096 train step whose bytes take about 13 us.
//
// Two modes, for a gradient g [B, S, F] of the lookup's [B, S, F] output:
//   fixed positions  out[pos[s]] = sum_b g[b, s]  for an [R, F] table and
//                    distinct rows pos [S]; every other row of out is 0
//                    (MAVAE.encode's agent-index embedding);
//   per-column bins  out[s*K + k] = sum_b [idx[b, s] == k] g[b, s]  for
//                    an [S, K, F] table, K <= 8 (the discrete action
//                    embeddings, StackedEmbedding).
// out is f32 and every row of it is written, so no zero-fill precedes it.
//
// Bytes bound it: one add per element read.  The design reads g once, in
// place and in its own type (f32, bf16 or f16), with one 16-byte load a
// thread per row (element by element where F or the base address does not
// allow it), 16 rows in flight per thread (4 in bins mode), and converts
// to f32 in registers.  Column s is split over one thread block cluster of
// kChunks blocks, each summing a chunk of the batch in registers (in bins
// mode K accumulators per element, each row added to the one its index
// names by a predicated add: no atomics on values), then across its warps
// in a fixed order into its shared memory.  The cluster then sums the
// kChunks partials in rank order, each block a share of the elements,
// reading the others' shared memory (Hopper's distributed shared memory),
// and writes the column's rows of out; one warp of the first block zeroes
// the rows no position names while the others read.  So the sum order is
// fixed and the result is the same bit for bit from run to run.  One
// launch, no workspace and no device-wide atomics: the partials never
// leave the cluster's shared memory.
//
// Built without fast math and with -fmad=false, as fused_elbo.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxBins = 8;        // ops/lookup_grad.py MAX_BINS
constexpr int kMaxFeatures = 256;  // a row of at most one warp's 16-byte loads
constexpr int kChunks = 8;         // blocks a column is split over, one cluster (ops/lookup_grad.py CHUNKS)
// A column's cluster of kChunks blocks leaves about two blocks an SM at
// the main path's 30 columns, so the register budget is two blocks' and
// each thread keeps as many rows in flight as fit: 16 (one round at
// B = 4,096), 4 in bins mode, whose K accumulators take the registers.
constexpr int kBlocksPerSm = 2;
constexpr int kFixedAhead = 16;
constexpr int kBinsAhead = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ __half zero<__half>() { return __float2half(0.f); }

// 16 bytes of T, loaded as one access
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// The E = 16 / sizeof(T) elements of segment `seg` of one row, in T (so
// that rows in flight hold 16 bytes of registers each): one 16-byte load
// where rows are aligned, else one element at a time with the ragged end
// read as 0.
template <typename T, bool ALIGNED>
__device__ __forceinline__ Pack<T> load_segment(const T* __restrict__ row, int seg, int features) {
  constexpr int E = 16 / sizeof(T);
  Pack<T> p;
  if (ALIGNED) {
    p = reinterpret_cast<const Pack<T>*>(row)[seg];
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int f = seg * E + i;
      p.v[i] = f < features ? row[f] : zero<T>();
    }
  }
  return p;
}

// Block (col, chunk), chunk its rank in the column's cluster.  A row of F
// elements is read by `lanes` neighbouring lanes (a power of two >=
// ceil(F / E)), so a warp reads 32 / lanes rows at once and the block
// kWarps times that.
template <typename T, typename I, bool BINS, bool ALIGNED>
__global__ void __cluster_dims__(1, kChunks, 1) __launch_bounds__(kThreads, kBlocksPerSm)
lookup_grad_kernel(const T* __restrict__ g, const I* __restrict__ idx,
                   const long long* __restrict__ pos, long long batch, int cols, int features,
                   int bins, int rows, int lanes, float* __restrict__ out) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kMaxK = BINS ? kMaxBins : 1;
  constexpr int kAhead = BINS ? kBinsAhead : kFixedAhead;
  const int col = blockIdx.x, chunk = blockIdx.y;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int seg = lane % lanes;
  const int rows_at_once = kWarps * (kWarp / lanes);
  const bool reads = seg * E < features;
  const int K = BINS ? bins : 1;

  if (!BINS && chunk == 0 && warp == 0) {
    // the rows of out that no position names, each by one warp, while the
    // block's other warps read
    for (int r = col; r < rows; r += cols) {
      bool named = false;
      for (int j = lane; j < cols; j += kWarp) named |= pos[j] == r;
      if (!__any_sync(0xffffffffu, named))
        for (int f = lane; f < features; f += kWarp) out[static_cast<long long>(r) * features + f] = 0.f;
    }
  }

  const long long per_chunk = (batch + kChunks - 1) / kChunks;
  const long long b0 = chunk * per_chunk;
  const long long b1 = min(batch, b0 + per_chunk);
  const long long row_step = static_cast<long long>(cols) * features;  // g[b, s] to g[b + 1, s]
  const T* g_col = g + static_cast<long long>(col) * features;

  float acc[kMaxK][E];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
#pragma unroll
    for (int i = 0; i < E; ++i) acc[k][i] = 0.f;

  // A row's bin as a bit mask (0: no bin), not an index: the compiler then
  // keeps acc in registers, where an index would let it address acc in
  // local memory.
  for (long long b = b0 + warp * (kWarp / lanes) + lane / lanes; b < b1; b += kAhead * rows_at_once) {
    Pack<T> raw[kAhead];
    unsigned int hit[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long bu = b + static_cast<long long>(u) * rows_at_once;
      const bool in = bu < b1 && reads;
      const long long bin = !in ? -1 : BINS ? static_cast<long long>(idx[bu * cols + col]) : 0;
      hit[u] = bin >= 0 && bin < kMaxK ? 1u << bin : 0u;
      if (in) {
        raw[u] = load_segment<T, ALIGNED>(g_col + bu * row_step, seg, features);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) raw[u].v[i] = zero<T>();
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float v[E];
#pragma unroll
      for (int i = 0; i < E; ++i) v[i] = to_f32(raw[u].v[i]);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
        if ((hit[u] >> k) & 1u)
#pragma unroll
          for (int i = 0; i < E; ++i) acc[k][i] += v[i];
      }
    }
  }

  // the block's sum, bin by bin: over the lanes of one segment within a
  // warp (a butterfly, so every lane of the segment holds the same sum),
  // then over the warps in order, into part [K][F]
  __shared__ float red[kWarps][kMaxFeatures];
  __shared__ float part[kMaxK * kMaxFeatures];
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    // acc[k], picked by constant indices so that acc stays in registers
    float a[E];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk)
      if (kk == k)
#pragma unroll
        for (int i = 0; i < E; ++i) a[i] = acc[kk][i];
    for (int off = kWarp / 2; off >= lanes; off >>= 1)
#pragma unroll
      for (int i = 0; i < E; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
    if (lane < lanes && reads)
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (seg * E + i < features) red[warp][seg * E + i] = a[i];
    __syncthreads();
    for (int f = threadIdx.x; f < features; f += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][f];
      part[k * features + f] = t;
    }
    __syncthreads();
  }

  // the cluster's sum: block `chunk` takes its share of the K * F elements
  // and adds the kChunks blocks' partials of each in rank order.  The
  // cluster barriers order every block's part before the reads, and every
  // read before any block exits (its shared memory goes with it).
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = K * features;
  const int share = (n + kChunks - 1) / kChunks;
  const int e1 = min(n, (chunk + 1) * share);
  for (int e = chunk * share + threadIdx.x; e < e1; e += kThreads) {
    float p[kChunks];
#pragma unroll
    for (int r = 0; r < kChunks; ++r) p[r] = cluster.map_shared_rank(part, r)[e];
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kChunks; ++r) t += p[r];
    const long long row = BINS ? static_cast<long long>(col) * K + e / features : pos[col];
    out[row * features + e % features] = t;
  }
  cluster.sync();
}

template <typename T, typename I, bool BINS>
int launch(const void* g, const void* idx, const long long* pos, long long batch, int cols,
           int features, int bins, int rows, int lanes, int aligned, float* out,
           cudaStream_t stream) {
  const dim3 grid(cols, kChunks);
  const T* gt = static_cast<const T*>(g);
  const I* it = static_cast<const I*>(idx);
  if (aligned)
    lookup_grad_kernel<T, I, BINS, true><<<grid, kThreads, 0, stream>>>(
        gt, it, pos, batch, cols, features, bins, rows, lanes, out);
  else
    lookup_grad_kernel<T, I, BINS, false><<<grid, kThreads, 0, stream>>>(
        gt, it, pos, batch, cols, features, bins, rows, lanes, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_index(int idx_type, const void* g, const void* idx, const long long* pos,
                 long long batch, int cols, int features, int bins, int rows, int lanes,
                 int aligned, float* out, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int segs = (features + E - 1) / E;
  if (features < 1 || features > kMaxFeatures || lanes < segs || lanes > kWarp ||
      (lanes & (lanes - 1)) != 0 || cols < 1 || (aligned && features % E != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (idx_type) {
    case -1:
      return launch<T, int, false>(g, idx, pos, batch, cols, features, 1, rows, lanes, aligned,
                                   out, stream);
    case 0:
      if (bins < 1 || bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
      return launch<T, int, true>(g, idx, pos, batch, cols, features, bins, rows, lanes, aligned,
                                  out, stream);
    case 1:
      if (bins < 1 || bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
      return launch<T, long long, true>(g, idx, pos, batch, cols, features, bins, rows, lanes,
                                        aligned, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// g [batch, cols, features] contiguous, dtype 0 float32, 1 bfloat16, 2
// float16.  idx_type -1: fixed positions (pos [cols] int64, distinct rows
// of out [rows, features]; idx unused); 0 / 1: per-column bins, idx
// [batch, cols] int32 / int64, out [cols * bins, features] (rows = cols *
// bins; pos unused).  lanes and aligned from ops/lookup_grad.py
// lookup_geometry.
int mfvae_lookup_grad(const void* g, int dtype, const void* idx, int idx_type,
                      const long long* pos, long long batch, int cols, int features, int bins,
                      int rows, int lanes, int aligned, float* out, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_index<float>(idx_type, g, idx, pos, batch, cols, features, bins, rows, lanes,
                                 aligned, out, stream);
    case 1:
      return launch_index<__nv_bfloat16>(idx_type, g, idx, pos, batch, cols, features, bins,
                                         rows, lanes, aligned, out, stream);
    case 2:
      return launch_index<__half>(idx_type, g, idx, pos, batch, cols, features, bins, rows,
                                  lanes, aligned, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
