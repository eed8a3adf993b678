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
//
// All three are bound by device-memory bytes: a handful of flops per float
// read.  The design keeps each tensor to one read and one write.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per row, 256 threads
constexpr int kReduceThreads = 256;

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

// K3 pass 1: a fixed grid of blocks, each summing a grid-stride slice of
// 0.5 q^2 + delta (|d| - q), d = x - y, q = min(|d|, delta), into
// partials[blockIdx.x].  Blocks run in no order on Hopper, so nothing is
// carried between them; the fixed grid keeps the sum order deterministic.
__global__ void huber_partial_kernel(const float* __restrict__ x,
                                     const float* __restrict__ y, float delta,
                                     long long n, float* __restrict__ partials) {
  float acc = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float d = fabsf(x[i] - y[i]);
    const float q = fminf(d, delta);
    acc += 0.5f * q * q + delta * (d - q);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// K3 pass 2: one block sums the partials in a fixed order and divides by n.
__global__ void huber_final_kernel(const float* __restrict__ partials, int nparts,
                                   long long n, float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc / static_cast<float>(n);
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

int mfvae_huber_mean(const float* x, const float* y, float delta, long long n,
                     float* partials, int nparts, float* out,
                     cudaStream_t stream) {
  huber_partial_kernel<<<nparts, kReduceThreads, 0, stream>>>(x, y, delta, n, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  huber_final_kernel<<<1, kReduceThreads, 0, stream>>>(partials, nparts, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
