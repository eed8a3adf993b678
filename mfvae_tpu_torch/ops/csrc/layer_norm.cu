// Hopper (sm_90a) kernel K5: flax's LayerNorm over the last axis, forward
// and backward.  Plain C entry points, bound from Python with ctypes
// (mfvae_tpu_torch/ops/layer_norm.py).  Each launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// K5 replaces no TPU kernel: on the TPU, XLA fused flax's LayerNorm into the
// passes around it.  In eager PyTorch the same formula (models/layers.py
// before K5) ran as 14 kernels forward (a cast to f32, two means, x*x,
// mean*mean, a subtraction, a clamp, +eps, rsqrt, the rsqrt*scale product,
// x - mean, the product, +bias, the cast back) and about 25 in autograd's
// backward, each a pass over [rows, D] in f32.  The world model's decoders
// run 12 of them a forward, two over the 15,900-wide decoder input.
//
// What it computes, per row of D values (statistics in f32, flax's fast
// variance, epsilon 1e-6):
//   mean = E[x], raw = E[x^2] - mean^2, rstd = rsqrt(max(raw, 0) + eps)
//   y    = (x - mean) * (rstd * scale) + bias       (stored in y's type)
// and backward, with gh = g * scale and xhat = (x - mean) * rstd:
//   dx     = rstd * (gh - E[gh] - xhat * E[gh * xhat])   (x's type)
//   dscale = sum over rows of g * xhat, dbias = sum over rows of g   (f32)
// Where the clamp engaged (raw < 0) the variance term E[gh * xhat] is
// dropped, as torch.clamp's backward passes no gradient below its min.
// The forward saves (mean, rstd) a row, rstd negated where the clamp
// engaged (rstd itself is always > 0), for the backward; under no_grad it
// saves nothing.
//
// Bytes bound it: a few operations per element.  The design reads x once
// and writes y once forward, and reads x and g once and writes dx once
// backward:
//   - A team of threads holds a row, each thread `cols` values of it, 64
//     bytes of the input (32 bf16 or f16 values, 16 f32): the smallest
//     power of two of threads, from a warp up to the 512-thread block, that
//     holds the row.  At D = 15,900 bf16 that is the whole block, at 1,024
//     a warp (16 rows a block).  A row wider than the block's share is read
//     again past it in the second pass.  The two sums of a row (forward:
//     sum x and sum x^2; backward: sum gh and sum gh * xhat) are taken in
//     one pass, a butterfly within each warp, then one over the team's
//     warps.  The forward holds its share in registers.
//   - Loads and stores are V values at once (8 or 16 bytes), where D is a
//     multiple of 4 and every tensor's base is aligned to that: 15,900 bf16
//     values are 31,800 bytes, so every other row starts 8 bytes off a
//     16-byte boundary, and 8-byte accesses keep every row aligned.
//     Elsewhere V = 1.
//   - A thread owns the same columns in every row.  The backward walks a
//     fixed, contiguous range of rows a block (one block an SM) and keeps
//     its columns' sums of g * xhat and g in registers; its share of x and
//     g comes through shared memory, the next row's on its way (cp.async)
//     while it reduces and writes one, and its columns of scale sit in
//     shared memory too (read from L2 twice a row, they cost the kernel
//     more time than the row itself).  Each block writes its partial sums
//     [blocks, 2, D]; a second launch sums the partials of each column in a
//     fixed order.  No atomics: two calls give the same bits.
//   - Inputs are read in their own type (f32, bf16 or f16) and converted in
//     registers; scale and bias are f32.
//
// Built without fast math and with -fmad=false, as fused_elbo.cu; the
// backward fuses the products into its sums (__fmaf_rn) where no other
// term reuses the rounded product, so g * scale minus its row mean still
// cancels exactly where a row's values are equal.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;  // a block
constexpr int kMaxWarps = kThreads / kWarp;
constexpr float kEps = 1e-6f;  // flax's epsilon, models/layers.py LayerNorm.EPSILON

// the values of a row a thread holds, 64 bytes of the input
template <typename T>
__host__ __device__ constexpr int cols_of() { return 64 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// V values of T, loaded or stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// (a, b) summed over the team of threads that holds one row: a butterfly
// within each warp (every lane ends with the same sums, as a + b == b + a),
// then, for a team of several warps, a butterfly over the team's warps'
// sums, read from `red` (each warp the same, so every thread ends with the
// same sums).  Every thread of the block calls it the same number of
// times (teams without a row too), as it holds a block barrier; `red` has
// a slot for each parity of the call, so one barrier a call keeps a slot
// from being overwritten while another warp still reads it.
__device__ __forceinline__ float2 team_sum(float a, float b, int team, int parity,
                                          float (&red)[2][2][kMaxWarps]) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (team > kWarp) {
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    const int warps = team / kWarp, first = warp - warp % warps;
    if (lane == 0) {
      red[parity][0][warp] = a;
      red[parity][1][warp] = b;
    }
    __syncthreads();
    // every warp of the team the same butterfly over the team's warps' sums
    a = lane < warps ? red[parity][0][first + lane] : 0.f;
    b = lane < warps ? red[parity][1][first + lane] : 0.f;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
  }
  return make_float2(a, b);
}

// Forward.  A team of `team` threads normalises one row: thread t holds
// vectors t, t + team, ... of the row, the first cols_of<TI>() / V of
// them in registers.  stats is null under no_grad.
template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_fwd_kernel(const TI* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, long long rows, int d, int team,
                      TO* __restrict__ y, float* __restrict__ stats) {
  constexpr int kVecs = cols_of<TI>() / V;
  __shared__ float red[2][2][kMaxWarps];
  const int t = threadIdx.x % team;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / team) + threadIdx.x / team;
  const bool active = row < rows;  // a team past the last row still joins team_sum's barrier
  const int nvec = active ? d / V : 0;
  const float inv_d = 1.f / static_cast<float>(d);
  const Vec<TI, V>* xr = reinterpret_cast<const Vec<TI, V>*>(x + (active ? row : 0) * d);

  Vec<TI, V> c[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (t + k * team < nvec) c[k] = xr[t + k * team];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (t + k * team < nvec)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(c[k].v[e]);
        s += f;
        q += f * f;
      }
  for (int i = t + kVecs * team; i < nvec; i += team) {  // columns past the registers
    const Vec<TI, V> a = xr[i];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_f32(a.v[e]);
      s += f;
      q += f * f;
    }
  }
  const float2 sums = team_sum(s, q, team, 0, red);
  if (!active) return;
  const float mean = sums.x * inv_d;
  const float raw = sums.y * inv_d - mean * mean;
  const float rstd = rsqrtf(fmaxf(raw, 0.f) + kEps);
  if (stats != nullptr && t == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = raw < 0.f ? -rstd : rstd;
  }

  const Vec<float, V>* sv = reinterpret_cast<const Vec<float, V>*>(scale);
  const Vec<float, V>* bv = reinterpret_cast<const Vec<float, V>*>(bias);
  Vec<TO, V>* yr = reinterpret_cast<Vec<TO, V>*>(y + row * d);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = t + k * team;
    if (i < nvec) {
      const Vec<float, V> sc = sv[i], bi = bv[i];
      Vec<TO, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = from_f32<TO>((to_f32(c[k].v[e]) - mean) * (rstd * sc.v[e]) + bi.v[e]);
      yr[i] = o;
    }
  }
  for (int i = t + kVecs * team; i < nvec; i += team) {
    const Vec<TI, V> a = xr[i];
    const Vec<float, V> sc = sv[i], bi = bv[i];
    Vec<TO, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = from_f32<TO>((to_f32(a.v[e]) - mean) * (rstd * sc.v[e]) + bi.v[e]);
    yr[i] = o;
  }
}

// Backward, part 1.  Block b walks rows [b * rows_per_block, ...), its
// teams side by side (team j of the block takes rows r0 + j, r0 + j +
// teams, ...), and writes dx.  Each thread owns the same columns in every
// row and adds the row's g * xhat and g of them into registers.  Its share
// of x and g of each row comes through a ring of kStages slots of its own
// in shared memory, copied kStages - 1 rows ahead (cp.async: the copies are
// in flight while it reduces and writes the row before; where a vector is
// under 4 bytes, the least cp.async copies, it copies them itself), and
// its columns of scale are copied into shared memory once; it reads back
// only what it copied, so neither needs a barrier.  At the end the block's
// column sums go to part[b][0] (dscale) and part[b][1] (dbias): a team of
// the whole block writes its registers; several teams add theirs in team
// order through shared memory.  Columns past the block's share (rows wider
// than 512 * cols_of<TI>(), where the team is the block) are read again
// and summed in part itself, each by the one thread that owns it.
template <typename TI, typename TO, int V>
struct BwdLayout {
  static constexpr int kVecs = cols_of<TI>() / V;
  static constexpr bool kAsync = sizeof(Vec<TI, V>) >= 4 && sizeof(Vec<TO, V>) >= 4;
  // one stage: every thread's kVecs vectors of x, then of g
  static constexpr int kStageX = kVecs * kThreads * static_cast<int>(sizeof(Vec<TI, V>));
  static constexpr int kStage = kStageX + kVecs * kThreads * static_cast<int>(sizeof(Vec<TO, V>));
  static constexpr int kStages = 2;
  // every thread's kVecs vectors of scale, after the ring
  static constexpr int kScale = kVecs * kThreads * static_cast<int>(sizeof(Vec<float, V>));
  // the teams' column sums at the end reuse the ring
  static constexpr int kSums = kThreads * cols_of<TI>() * 2 * static_cast<int>(sizeof(float));
  static constexpr int kSmem = (kStages * kStage > kSums ? kStages * kStage : kSums) + kScale;
};

template <typename T, int V, bool ASYNC>
__device__ __forceinline__ void copy_vec(Vec<T, V>* dst, const Vec<T, V>* src) {
  if constexpr (ASYNC) {
    __pipeline_memcpy_async(dst, src, sizeof(Vec<T, V>));
  } else {
    *dst = *src;
  }
}

template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kThreads, 1)
layer_norm_bwd_kernel(const TI* __restrict__ x, const TO* __restrict__ g,
                      const float* __restrict__ scale, const float* __restrict__ stats,
                      long long rows, int d, int team, long long rows_per_block,
                      TI* __restrict__ dx, float* __restrict__ part) {
  using L = BwdLayout<TI, TO, V>;
  constexpr int kVecs = L::kVecs;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][2][kMaxWarps];
  const int t = threadIdx.x % team, teams = kThreads / team, tm = threadIdx.x / team;
  const int nvec = d / V;
  const int held = min(nvec, team * kVecs);  // vectors of a row the team holds
  const float inv_d = 1.f / static_cast<float>(d);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float* pscale = part + static_cast<long long>(blockIdx.x) * 2 * d;
  float* pbias = pscale + d;
  const Vec<float, V>* sv = reinterpret_cast<const Vec<float, V>*>(scale);

  // this thread's slot k of stage s
  auto slot_x = [&](int s, int k) {
    return reinterpret_cast<Vec<TI, V>*>(smem + s * L::kStage) + k * kThreads + threadIdx.x;
  };
  auto slot_g = [&](int s, int k) {
    return reinterpret_cast<Vec<TO, V>*>(smem + s * L::kStage + L::kStageX) + k * kThreads + threadIdx.x;
  };
  // this thread's slot k of scale
  auto slot_s = [&](int k) {
    return reinterpret_cast<Vec<float, V>*>(smem + (L::kSmem - L::kScale)) + k * kThreads + threadIdx.x;
  };
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (t + k * team < held) *slot_s(k) = sv[t + k * team];
  // the copies of row r into stage s, as one group (empty past the block's rows)
  auto fetch = [&](long long r, int s) {
    if (r < r1) {
      const Vec<TI, V>* xr = reinterpret_cast<const Vec<TI, V>*>(x + r * d);
      const Vec<TO, V>* gr = reinterpret_cast<const Vec<TO, V>*>(g + r * d);
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (t + k * team < held) {
          copy_vec<TI, V, L::kAsync>(slot_x(s, k), xr + t + k * team);
          copy_vec<TO, V, L::kAsync>(slot_g(s, k), gr + t + k * team);
        }
    }
    if constexpr (L::kAsync) __pipeline_commit();
  };

  float ds[kVecs][V], db[kVecs][V];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) ds[k][e] = db[k][e] = 0.f;

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) fetch(r0 + tm + s * teams, s);
  int parity = 0, stage = 0;
  for (long long base = r0; base < r1; base += teams, parity ^= 1) {
    const long long row = base + tm;
    const bool active = row < r1;
    fetch(row + (L::kStages - 1) * teams, (stage + L::kStages - 1) % L::kStages);
    if constexpr (L::kAsync) __pipeline_wait_prior(L::kStages - 1);  // this row's group has landed
    float mean = 0.f, signed_rstd = 1.f;
    if (active) {
      mean = stats[2 * row];
      signed_rstd = stats[2 * row + 1];
    }
    const float rstd = fabsf(signed_rstd);
    const Vec<TI, V>* xr = reinterpret_cast<const Vec<TI, V>*>(x + (active ? row : 0) * d);
    const Vec<TO, V>* gr = reinterpret_cast<const Vec<TO, V>*>(g + (active ? row : 0) * d);
    const int reach = active ? held : 0, past = active ? nvec : 0;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = t + k * team;
      if (i < reach) {
        const Vec<TI, V> xv = *slot_x(stage, k);
        const Vec<TO, V> gv = *slot_g(stage, k);
        const Vec<float, V> sc = *slot_s(k);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gh = to_f32(gv.v[e]) * sc.v[e];
          a += gh;
          b = __fmaf_rn(gh, (to_f32(xv.v[e]) - mean) * rstd, b);
        }
      }
    }
    for (int i = held + t; i < past; i += team) {  // columns past the registers
      const Vec<TI, V> xv = xr[i];
      const Vec<TO, V> gv = gr[i];
      const Vec<float, V> sc = sv[i];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float gh = to_f32(gv.v[e]) * sc.v[e];
        a += gh;
        b = __fmaf_rn(gh, (to_f32(xv.v[e]) - mean) * rstd, b);
      }
    }
    const float2 sums = team_sum(a, b, team, parity, red);
    const float ma = sums.x * inv_d;
    const float mb = signed_rstd > 0.f ? sums.y * inv_d : 0.f;  // the clamp passes no gradient

    Vec<TI, V>* dxr = reinterpret_cast<Vec<TI, V>*>(dx + (active ? row : 0) * d);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = t + k * team;
      if (i < reach) {
        const Vec<TI, V> xv = *slot_x(stage, k);
        const Vec<TO, V> gv = *slot_g(stage, k);
        const Vec<float, V> sc = *slot_s(k);
        Vec<TI, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gf = to_f32(gv.v[e]);
          const float xh = (to_f32(xv.v[e]) - mean) * rstd;
          o.v[e] = from_f32<TI>(rstd * __fmaf_rn(-xh, mb, gf * sc.v[e] - ma));
          ds[k][e] = __fmaf_rn(gf, xh, ds[k][e]);
          db[k][e] += gf;
        }
        dxr[i] = o;
      }
    }
    for (int i = held + t; i < past; i += team) {
      const Vec<TI, V> xv = xr[i];
      const Vec<TO, V> gv = gr[i];
      const Vec<float, V> sc = sv[i];
      Vec<TI, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = i * V + e;
        const float gf = to_f32(gv.v[e]);
        const float xh = (to_f32(xv.v[e]) - mean) * rstd;
        o.v[e] = from_f32<TI>(rstd * __fmaf_rn(-xh, mb, gf * sc.v[e] - ma));
        pscale[col] = __fmaf_rn(gf, xh, row == r0 ? 0.f : pscale[col]);
        pbias[col] = (row == r0 ? 0.f : pbias[col]) + gf;
      }
      dxr[i] = o;
    }
    stage = (stage + 1) % L::kStages;
  }

  // the block's column sums of the registers' columns
  if (teams == 1) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = t + k * team;
      if (i < held) {
        Vec<float, V> vs, vb;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          vs.v[e] = ds[k][e];
          vb.v[e] = db[k][e];
        }
        reinterpret_cast<Vec<float, V>*>(pscale)[i] = vs;
        reinterpret_cast<Vec<float, V>*>(pbias)[i] = vb;
      }
    }
    return;
  }
  // several teams: each team's sums into the ring's memory, then the teams'
  // sums of each column in team order
  if constexpr (L::kAsync) __pipeline_wait_prior(0);
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);  // [teams][2][held * V]
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = t + k * team;
    if (i < held)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sums[(tm * 2) * held * V + i * V + e] = ds[k][e];
        sums[(tm * 2 + 1) * held * V + i * V + e] = db[k][e];
      }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < held * V; col += kThreads) {
    float ts = 0.f, tb = 0.f;
    for (int w = 0; w < teams; ++w) {
      ts += sums[(w * 2) * held * V + col];
      tb += sums[(w * 2 + 1) * held * V + col];
    }
    pscale[col] = ts;
    pbias[col] = tb;
  }
}

// Backward, part 2: dscale[j] and dbias[j], the blocks' partials of column j
// summed in a fixed order: a block takes 32 neighbouring columns of one of
// the two, each of its 8 warps the sum over a contiguous eighth of the
// blocks' partials, then the warps' sums in warp order.
constexpr int kGradGroups = 8;
__global__ void __launch_bounds__(kWarp * kGradGroups)
layer_norm_param_grad_kernel(const float* __restrict__ part, int blocks, int d,
                             float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float sums[kGradGroups][kWarp];
  const int lane = threadIdx.x % kWarp, group = threadIdx.x / kWarp;
  const int chunks = (d + kWarp - 1) / kWarp;
  const int which = blockIdx.x / chunks, col = (blockIdx.x % chunks) * kWarp + lane;
  const int per = (blocks + kGradGroups - 1) / kGradGroups;
  const int b0 = group * per, b1 = min(blocks, b0 + per);
  float s = 0.f;
  if (col < d) {
    const float* p = part + static_cast<long long>(which) * d + col;
    for (int b = b0; b < b1; ++b) s += p[2LL * d * b];
  }
  sums[group][lane] = s;
  __syncthreads();
  if (group == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kGradGroups; ++w) t += sums[w][lane];
    (which == 0 ? dscale : dbias)[col] = t;
  }
}

// How K5 reads rows of d values: vec, the values an access, 4 (8 or 16
// bytes) where d is a multiple of 4 and every base the launch reads or
// writes by rows or by columns is aligned to 4 of its values, so every
// row is, else 1; and team, the fewest threads, a power of two from a
// warp up to the block, whose registers hold the row (cols_of of the
// input).  The forward and the backward read a row alike.
struct Base {
  const void* p;
  int size;  // bytes a value
};

int type_size(int type) { return type == 0 ? 4 : 2; }

void row_geometry(int in_type, int d, std::initializer_list<Base> bases, int* vec, int* team) {
  bool aligned = d % 4 == 0;
  for (const Base& b : bases) aligned = aligned && reinterpret_cast<uintptr_t>(b.p) % (4 * b.size) == 0;
  *vec = aligned ? 4 : 1;
  const int cols = in_type == 0 ? cols_of<float>() : cols_of<__nv_bfloat16>();
  *team = kWarp;
  while (*team < kThreads && d > *team * cols) *team *= 2;
}

// The backward's grid: at most one block an SM of the current device (its
// registers hold the column sums, its shared memory two rows a team), each
// over a contiguous range of rows, every block with at least one row.
int backward_grid(long long rows, int team, int* blocks, long long* rows_per_block) {
  int device = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err != 0) return err;
  const long long rows_a_block = kThreads / team;
  const long long most = std::max(1LL, std::min<long long>(sms, (rows + rows_a_block - 1) / rows_a_block));
  *rows_per_block = (rows + most - 1) / most;
  *blocks = static_cast<int>((rows + *rows_per_block - 1) / *rows_per_block);
  return 0;
}

template <typename TI, typename TO, int V>
struct Fwd {
  static int run(const void* x, const float* scale, const float* bias, long long rows, int d,
                 int team, void* y, float* stats, cudaStream_t stream) {
    const long long per_block = kThreads / team;
    const long long blocks = (rows + per_block - 1) / per_block;
    layer_norm_fwd_kernel<TI, TO, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const TI*>(x), scale, bias, rows, d, team, static_cast<TO*>(y), stats);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TI, typename TO, int V>
struct Bwd {
  static int run(const void* x, const void* g, const float* scale, const float* stats,
                 long long rows, int d, int team, int blocks, long long rows_per_block,
                 void* dx, float* part, float* dscale, float* dbias, cudaStream_t stream) {
    constexpr int smem = BwdLayout<TI, TO, V>::kSmem;
    const int set = static_cast<int>(cudaFuncSetAttribute(
        layer_norm_bwd_kernel<TI, TO, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (set != 0) return set;
    layer_norm_bwd_kernel<TI, TO, V><<<blocks, kThreads, smem, stream>>>(
        static_cast<const TI*>(x), static_cast<const TO*>(g), scale, stats, rows, d, team,
        rows_per_block, static_cast<TI*>(dx), part);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int chunks = (d + kWarp - 1) / kWarp;
    layer_norm_param_grad_kernel<<<2 * chunks, kWarp * kGradGroups, 0, stream>>>(part, blocks, d,
                                                                              dscale, dbias);
    return static_cast<int>(cudaGetLastError());
  }
};

// The (input, output) types K5 reads and writes: f32 into any of the three,
// or bf16 / f16 into its own type.  ops/layer_norm.py casts anything else
// to f32 first, as the plain chain's first op does.
template <template <typename, typename, int> class F, typename... Args>
int dispatch(int in_type, int out_type, int vec, Args... args) {
#define MFVAE_K5_CASE(TI, TO) \
  return vec == 4 ? F<TI, TO, 4>::run(args...) : F<TI, TO, 1>::run(args...)
  if (in_type == 0 && out_type == 0) MFVAE_K5_CASE(float, float);
  if (in_type == 0 && out_type == 1) MFVAE_K5_CASE(float, __nv_bfloat16);
  if (in_type == 0 && out_type == 2) MFVAE_K5_CASE(float, __half);
  if (in_type == 1 && out_type == 1) MFVAE_K5_CASE(__nv_bfloat16, __nv_bfloat16);
  if (in_type == 2 && out_type == 2) MFVAE_K5_CASE(__half, __half);
#undef MFVAE_K5_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x [rows, d] contiguous of in_type, y [rows, d] of out_type (0 float32,
// 1 bfloat16, 2 float16); scale, bias [d] f32; stats [rows, 2] f32 or null.
int mfvae_layer_norm_fwd(const void* x, int in_type, int out_type, const float* scale,
                         const float* bias, long long rows, int d, void* y, float* stats,
                         cudaStream_t stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int vec = 1, team = kWarp;
  row_geometry(in_type, d,
               {{x, type_size(in_type)}, {y, type_size(out_type)}, {scale, 4}, {bias, 4}}, &vec,
               &team);
  return dispatch<Fwd>(in_type, out_type, vec, x, scale, bias, rows, d, team, y, stats, stream);
}

// The backward's blocks for rows of d values of in_type: the rows of the
// partials [blocks, 2, d] it writes.
int mfvae_layer_norm_bwd_blocks(int in_type, long long rows, int d, int* blocks) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int vec = 1, team = kWarp;
  long long rows_per_block = 0;
  row_geometry(in_type, d, {}, &vec, &team);
  return backward_grid(rows, team, blocks, &rows_per_block);
}

// x [rows, d] of in_type and g [rows, d] of out_type, contiguous; stats the
// forward's; dx [rows, d] of in_type; part [blocks, 2, d] f32 scratch, with
// blocks from mfvae_layer_norm_bwd_blocks; dscale, dbias [d] f32.
int mfvae_layer_norm_bwd(const void* x, int in_type, const void* g, int out_type,
                         const float* scale, const float* stats, long long rows, int d, void* dx,
                         float* part, float* dscale, float* dbias, cudaStream_t stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int vec = 1, team = kWarp, blocks = 0;
  long long rows_per_block = 0;
  row_geometry(in_type, d,
               {{x, type_size(in_type)}, {g, type_size(out_type)}, {dx, type_size(in_type)},
                {scale, 4}, {part, 4}},
               &vec, &team);
  const int err = backward_grid(rows, team, &blocks, &rows_per_block);
  if (err != 0) return err;
  return dispatch<Bwd>(in_type, out_type, vec, x, g, scale, stats, rows, d, team, blocks,
                       rows_per_block, dx, part, dscale, dbias, stream);
}

// The geometry of a launch, for tests: out[0] vec and out[1] team of rows
// x [rows, d] of in_type beside rows `other` of other_type (y or g) and
// scale; out[2] the backward's blocks and out[3] its rows a block.
int mfvae_layer_norm_geometry(const void* x, int in_type, const void* other, int other_type,
                              const float* scale, long long rows, int d, long long* out) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int vec = 1, team = kWarp, blocks = 0;
  long long rows_per_block = 0;
  row_geometry(in_type, d, {{x, type_size(in_type)}, {other, type_size(other_type)}, {scale, 4}},
               &vec, &team);
  const int err = backward_grid(rows, team, &blocks, &rows_per_block);
  out[0] = vec;
  out[1] = team;
  out[2] = blocks;
  out[3] = rows_per_block;
  return err;
}

}  // extern "C"
