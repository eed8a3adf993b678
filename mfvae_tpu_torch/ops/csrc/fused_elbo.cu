// Hopper (sm_90a) kernels for the ELBO elementwise tail of the MAVAE train
// step.  Plain C entry points, bound from Python with ctypes
// (mfvae_tpu_torch/ops/fused_elbo.py).  Each entry launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError().
//
// Built without fast math and with -fmad=false, so every product and sum
// rounds exactly as the plain PyTorch versions in fused_elbo.py do when
// they are evaluated in the same order; expf is the accurate one.
//
//   K1 reparam_kl_fwd   replaces mfvae_tpu/ops/fused_elbo.py _fwd_kernel
//   K2 reparam_kl_bwd   replaces mfvae_tpu/ops/fused_elbo.py _bwd_kernel
//   K3 huber_mean       replaces mfvae_tpu/ops/fused_elbo.py _huber_kernel
//                       (:164, launched by _huber_impl :184)
//   K3w huber_rows_wsum the masked, pooled huber terms of the unroll step
//                       (training/unroll.py): sum_r w_r mean_d huber(x - y)
//
// All three are bound by device-memory bytes: a handful of flops per float
// read.  The design keeps each tensor to one read and one write.
//
// K3 is one launch per call.  The TPU kernel carries one running sum over
// its sequential grid; Hopper's blocks run in no order, so each block
// writes its partial to its own slot of a workspace, takes a ticket from an
// arrival counter, and the block that arrives last sums the partials in a
// fixed order, writes the mean and sets the counter back to 0.  No float
// atomics: the sum order, and so the result, is the same on every run.
// Inputs are read in place in their own type (f32, bf16 or f16) with
// 16-byte loads, two per tensor in flight per thread, and converted to f32
// in registers, as the TPU kernel's astype(f32) inside its body does.  A
// small n takes one block, which writes the mean directly.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cuda/atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per row, 256 threads
constexpr int kReduceThreads = 256;
// K3's register budget keeps 4 blocks resident per SM; the wrapper caps
// K3's grid at 4 x SMs, one wave (ops/fused_elbo.py _HUBER_BLOCKS_PER_SM).
constexpr int kHuberBlocksPerSm = 4;
// 16-byte loads per tensor in flight per thread (ops/fused_elbo.py _HUBER_LOADS)
constexpr int kHuberLoads = 2;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float x) { v = x; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static float get(const T& v, int i) { return i == 0 ? v.x : v.y; }
  __device__ static void set(T& v, int i, float x) {
    if (i == 0) v.x = x; else v.y = x;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K1.  z = mu + eps * exp(0.5 lv);  kl[row] = sum_f -0.5 (1 + lv - mu^2 - e^lv)
// One warp per row of F floats; lane l reads VEC contiguous floats at
// column VEC*l, VEC*l + 32*VEC, ...  Rows past `rows` are masked.
template <int VEC>
__global__ void reparam_kl_fwd_kernel(const float* __restrict__ mu,
                                      const float* __restrict__ lv,
                                      const float* __restrict__ eps,
                                      float* __restrict__ z,
                                      float* __restrict__ kl, int rows, int f) {
  using V = Vec<VEC>;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * f;
  const typename V::T* mu_v = reinterpret_cast<const typename V::T*>(mu + base);
  const typename V::T* lv_v = reinterpret_cast<const typename V::T*>(lv + base);
  const typename V::T* eps_v = reinterpret_cast<const typename V::T*>(eps + base);
  typename V::T* z_v = reinterpret_cast<typename V::T*>(z + base);
  float acc = 0.f;
  for (int c = lane; c < f / VEC; c += kWarp) {
    const typename V::T m = mu_v[c], l = lv_v[c], e = eps_v[c];
    typename V::T out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float mi = V::get(m, i), li = V::get(l, i), ei = V::get(e, i);
      const float std_ = expf(0.5f * li);
      V::set(out, i, mi + ei * std_);
      const float elv = std_ * std_;
      acc += -0.5f * (1.0f + li - mi * mi - elv);
    }
    z_v[c] = out;
  }
  acc = warp_sum(acc);
  if (lane == 0) kl[row] = acc;
}

// K2.  dmu = gz + gkl * mu;  dlv = 0.5 gz eps std - 0.5 gkl (1 - e^lv).
// Same row mapping as K1; gkl[row] is read once per warp.  std is
// recomputed from lv instead of being stored by the forward.
template <int VEC>
__global__ void reparam_kl_bwd_kernel(const float* __restrict__ mu,
                                      const float* __restrict__ lv,
                                      const float* __restrict__ eps,
                                      const float* __restrict__ gz,
                                      const float* __restrict__ gkl,
                                      float* __restrict__ dmu,
                                      float* __restrict__ dlv, int rows, int f) {
  using V = Vec<VEC>;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * f;
  const typename V::T* mu_v = reinterpret_cast<const typename V::T*>(mu + base);
  const typename V::T* lv_v = reinterpret_cast<const typename V::T*>(lv + base);
  const typename V::T* eps_v = reinterpret_cast<const typename V::T*>(eps + base);
  const typename V::T* gz_v = reinterpret_cast<const typename V::T*>(gz + base);
  typename V::T* dmu_v = reinterpret_cast<typename V::T*>(dmu + base);
  typename V::T* dlv_v = reinterpret_cast<typename V::T*>(dlv + base);
  const float g = gkl[row];
  for (int c = lane; c < f / VEC; c += kWarp) {
    const typename V::T m = mu_v[c], l = lv_v[c], e = eps_v[c], gzv = gz_v[c];
    typename V::T om, ol;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float mi = V::get(m, i), li = V::get(l, i), ei = V::get(e, i);
      const float gi = V::get(gzv, i);
      const float std_ = expf(0.5f * li);
      const float elv = std_ * std_;
      V::set(om, i, gi + g * mi);
      V::set(ol, i, gi * 0.5f * ei * std_ + g * -0.5f * (1.0f - elv));
    }
    dmu_v[c] = om;
    dlv_v[c] = ol;
  }
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kReduceThreads / kWarp];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  v = warp_sum(v);
  if (lane == 0) warp_part[w] = v;
  __syncthreads();
  v = threadIdx.x < kReduceThreads / kWarp ? warp_part[threadIdx.x] : 0.f;
  if (w == 0) v = warp_sum(v);
  return v;  // valid in thread 0
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// VEC elements of T, loaded as one 16-byte access when VEC * sizeof(T) == 16
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// 0.5 q^2 + delta (|d| - q), d = x - y, q = min(|d|, delta), in f32
__device__ __forceinline__ float huber_term(float x, float y, float delta) {
  const float d = fabsf(x - y);
  const float q = fminf(d, delta);
  return 0.5f * q * q + delta * (d - q);
}

template <typename T, int VEC>
__device__ __forceinline__ float huber_pack(const Pack<T, VEC>& a, const Pack<T, VEC>& b,
                                            float delta, float acc) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc += huber_term(to_f32(a.v[i]), to_f32(b.v[i]), delta);
  return acc;
}

// K3.  Elements [0, head) and the tail past the last whole pack are taken
// one at a time (fewer than VEC each; x + head and y + head are 16-byte
// aligned when VEC > 1).  The packs are read grid-stride, kHuberLoads per
// tensor per iteration, all issued before the first is used.  workspace:
// arrivals[0] (0 between calls), then one f32 partial per block; unused
// when gridDim.x == 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kReduceThreads, kHuberBlocksPerSm)
huber_mean_kernel(const T* __restrict__ x, const T* __restrict__ y, float delta,
                  long long n, int head, unsigned int* __restrict__ arrivals,
                  float* __restrict__ partials, float* __restrict__ out) {
  using P = Pack<T, VEC>;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long npacks = (n - head) / VEC;
  const long long tail = head + npacks * VEC;
  float acc = 0.f;
  if (tid < head) acc += huber_term(to_f32(x[tid]), to_f32(y[tid]), delta);
  if (tid < n - tail) acc += huber_term(to_f32(x[tail + tid]), to_f32(y[tail + tid]), delta);
  const P* xp = reinterpret_cast<const P*>(x + head);
  const P* yp = reinterpret_cast<const P*>(y + head);
  for (long long i = tid; i < npacks; i += kHuberLoads * stride) {
    P a[kHuberLoads], b[kHuberLoads];
#pragma unroll
    for (int u = 0; u < kHuberLoads; ++u) {
      if (i + u * stride < npacks) {
        a[u] = xp[i + u * stride];
        b[u] = yp[i + u * stride];
      }
    }
#pragma unroll
    for (int u = 0; u < kHuberLoads; ++u)
      if (i + u * stride < npacks) acc = huber_pack(a[u], b[u], delta, acc);
  }
  acc = block_sum(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) *out = acc / static_cast<float>(n);
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    // release: this partial is visible to whoever takes a later ticket;
    // acquire: the last block sees every earlier block's partial.  Lighter
    // than __threadfence() (fence.sc) and measured faster on the H100.
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*arrivals);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float s = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x)
    s += __ldcg(partials + i);  // from L2, where the other blocks wrote
  s = block_sum(s);
  if (threadIdx.x == 0) {
    *out = s / static_cast<float>(n);
    *arrivals = 0u;  // ready for the next call on this stream
  }
}

template <typename T, int VEC>
int launch_huber(const void* x, const void* y, float delta, long long n, int head,
                 int blocks, void* workspace, float* out, cudaStream_t stream) {
  unsigned int* arrivals = static_cast<unsigned int*>(workspace);
  huber_mean_kernel<T, VEC><<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), delta, n, head, arrivals,
      reinterpret_cast<float*>(arrivals + 1), out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_huber_vec(int vec, const void* x, const void* y, float delta, long long n,
                     int head, int blocks, void* workspace, float* out,
                     cudaStream_t stream) {
  constexpr int kPack = 16 / sizeof(T);
  if (vec == kPack)
    return launch_huber<T, kPack>(x, y, delta, n, head, blocks, workspace, out, stream);
  if (vec == 1 && head == 0)
    return launch_huber<T, 1>(x, y, delta, n, 0, blocks, workspace, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3w.  sum_r w[r] * mean_d huber(x[r, d] - y[r, d]) over R rows of d
// elements, as one f32: the flat sum of w[row(e)] * huber(e), divided by d
// at the end.  The same one-launch reduction as K3 (grid-stride packs, the
// partials summed in a fixed order by the block that arrives last), each
// element weighted by its row's weight.  A pack holds VEC elements of at
// most two rows (the wrapper takes VEC > 1 only where d >= VEC); a thread
// finds the (row, column) of its first pack with one division and moves
// them on by the hop's quotient and remainder, with no division in the
// loop.  The weights, 4 bytes a row, are read once a pack, from cache.
template <typename T, int VEC>
__device__ __forceinline__ float huber_wpack(const Pack<T, VEC>& a, const Pack<T, VEC>& b,
                                             const float* __restrict__ w, long long row,
                                             long long col, long long d, float delta,
                                             float acc) {
  const float w0 = w[row];
  const float w1 = col + VEC > d ? w[row + 1] : w0;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    acc += (col + i < d ? w0 : w1) * huber_term(to_f32(a.v[i]), to_f32(b.v[i]), delta);
  return acc;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kReduceThreads, kHuberBlocksPerSm)
huber_rows_wsum_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ w, float delta, long long n, long long d,
                       int head, unsigned int* __restrict__ arrivals,
                       float* __restrict__ partials, float* __restrict__ out) {
  using P = Pack<T, VEC>;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long npacks = (n - head) / VEC;
  const long long tail = head + npacks * VEC;
  float acc = 0.f;
  if (tid < head) acc += w[tid / d] * huber_term(to_f32(x[tid]), to_f32(y[tid]), delta);
  if (tid < n - tail) {
    const long long e = tail + tid;
    acc += w[e / d] * huber_term(to_f32(x[e]), to_f32(y[e]), delta);
  }
  const P* xp = reinterpret_cast<const P*>(x + head);
  const P* yp = reinterpret_cast<const P*>(y + head);
  const long long hop = stride * VEC;  // elements from one of a thread's packs to the next
  const long long hop_rows = hop / d, hop_cols = hop - hop_rows * d;
  long long row = (head + tid * VEC) / d;
  long long col = head + tid * VEC - row * d;
  for (long long i = tid; i < npacks; i += kHuberLoads * stride) {
    P a[kHuberLoads], b[kHuberLoads];
    long long r[kHuberLoads], c[kHuberLoads];
#pragma unroll
    for (int u = 0; u < kHuberLoads; ++u) {
      r[u] = u == 0 ? row : r[u - 1] + hop_rows;
      c[u] = u == 0 ? col : c[u - 1] + hop_cols;
      if (c[u] >= d) {
        c[u] -= d;
        ++r[u];
      }
      if (i + u * stride < npacks) {
        a[u] = xp[i + u * stride];
        b[u] = yp[i + u * stride];
      }
    }
#pragma unroll
    for (int u = 0; u < kHuberLoads; ++u)
      if (i + u * stride < npacks) acc = huber_wpack(a[u], b[u], w, r[u], c[u], d, delta, acc);
    row = r[kHuberLoads - 1] + hop_rows;
    col = c[kHuberLoads - 1] + hop_cols;
    if (col >= d) {
      col -= d;
      ++row;
    }
  }
  acc = block_sum(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) *out = acc / static_cast<float>(d);
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*arrivals);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float s = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x)
    s += __ldcg(partials + i);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    *out = s / static_cast<float>(d);
    *arrivals = 0u;
  }
}

template <typename T>
int launch_wsum_vec(int vec, const void* x, const void* y, const float* w, float delta,
                    long long n, long long d, int head, int blocks, void* workspace,
                    float* out, cudaStream_t stream) {
  constexpr int kPack = 16 / sizeof(T);
  unsigned int* arrivals = static_cast<unsigned int*>(workspace);
  float* partials = reinterpret_cast<float*>(arrivals + 1);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  if (vec == kPack && d >= kPack)
    huber_rows_wsum_kernel<T, kPack><<<blocks, kReduceThreads, 0, stream>>>(
        xt, yt, w, delta, n, d, head, arrivals, partials, out);
  else if (vec == 1 && head == 0)
    huber_rows_wsum_kernel<T, 1><<<blocks, kReduceThreads, 0, stream>>>(
        xt, yt, w, delta, n, d, 0, arrivals, partials, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mfvae_reparam_kl_fwd(const float* mu, const float* lv, const float* eps,
                         float* z, float* kl, int rows, int f, int vec,
                         cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * kWarp);
  if (vec == 2)
    reparam_kl_fwd_kernel<2><<<grid, block, 0, stream>>>(mu, lv, eps, z, kl, rows, f);
  else
    reparam_kl_fwd_kernel<1><<<grid, block, 0, stream>>>(mu, lv, eps, z, kl, rows, f);
  return static_cast<int>(cudaGetLastError());
}

int mfvae_reparam_kl_bwd(const float* mu, const float* lv, const float* eps,
                         const float* gz, const float* gkl, float* dmu,
                         float* dlv, int rows, int f, int vec,
                         cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * kWarp);
  if (vec == 2)
    reparam_kl_bwd_kernel<2><<<grid, block, 0, stream>>>(mu, lv, eps, gz, gkl, dmu,
                                                          dlv, rows, f);
  else
    reparam_kl_bwd_kernel<1><<<grid, block, 0, stream>>>(mu, lv, eps, gz, gkl, dmu,
                                                          dlv, rows, f);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and y alike).  vec: 1, or the
// elements in 16 bytes.  workspace: 1 + blocks 32-bit words, word 0 zero.
int mfvae_huber_mean_onepass(const void* x, const void* y, int dtype, float delta,
                             long long n, int vec, int head, int blocks,
                             void* workspace, float* out, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_huber_vec<float>(vec, x, y, delta, n, head, blocks, workspace, out, stream);
    case 1:
      return launch_huber_vec<__nv_bfloat16>(vec, x, y, delta, n, head, blocks, workspace,
                                             out, stream);
    case 2:
      return launch_huber_vec<__half>(vec, x, y, delta, n, head, blocks, workspace, out,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3w.  x, y [n = rows * d] of one dtype (0 float32, 1 bfloat16, 2
// float16), w [rows] float32; vec, head, blocks and workspace as for
// mfvae_huber_mean_onepass (vec > 1 needs d >= vec).
int mfvae_huber_rows_wsum(const void* x, const void* y, const float* w, int dtype,
                          float delta, long long n, long long d, int vec, int head,
                          int blocks, void* workspace, float* out, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_wsum_vec<float>(vec, x, y, w, delta, n, d, head, blocks, workspace, out,
                                    stream);
    case 1:
      return launch_wsum_vec<__nv_bfloat16>(vec, x, y, w, delta, n, d, head, blocks,
                                            workspace, out, stream);
    case 2:
      return launch_wsum_vec<__half>(vec, x, y, w, delta, n, d, head, blocks, workspace, out,
                                     stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
