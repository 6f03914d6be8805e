// Batch normalization forward (K6a) and backward (K6b) for Hopper
// (sm_90a), CUDA C++, over channel-last data.
//
// Not a port of a Pallas kernel: the JAX package leaves BatchNorm to XLA,
// which fuses it inside the jitted training step.  These kernels compute
// the function that mxnet_tpu/ops/nn.py batch_norm (lines 461-515) writes,
// for x seen as M = N*H*W rows of C contiguous channels, in float32,
// bfloat16 and float16 (ops/batch_norm.py holds the plain version of each
// and the launch plan):
//
//   K6a, train mode:  bf16/f16: float32 sums of x and x^2 per channel in
//                     one pass, var = max(E[x^2] - E[x]^2, 0), mean and var
//                     rounded to the data's type; float32: the mean first,
//                     then sum (x - mean)^2 in a second pass;
//                     inv = rsqrt(float(var) + eps), scale = gamma * inv
//                     rounded to the data's type (gamma taken as 1 under
//                     fix_gamma), beta rounded to it;
//                     y = ((x - mean) * scale) + beta, each of the three
//                     operations rounded to the data's type;
//                     optionally running = running * m + stat * (1 - m),
//                     with stat * (1 - m) rounded to the data's type.
//   K6a, predict:     the apply pass alone over the running statistics
//                     (mean rounded to the data's type, var not).
//   K6b:              S1 = sum dy, S2 = sum dy (x - mean) in float32, then
//                     dbeta = S1, dgamma = inv S2 (0 under fix_gamma), and
//                     dx = scale (dy - S1/M) - gamma inv^3 (x - mean) S2/M,
//                     rounded once to the data's type (predict mode:
//                     dx = scale dy).  This is the derivative of the
//                     forward as written (its direct and mean terms carry
//                     the rounded scale, the variance term the float32
//                     gamma * inv), evaluated in float32; JAX's autodiff
//                     rounds each intermediate to bf16 instead.
//
// Bound on the H100: bytes.  The work is a few flops an element; each
// pass streams the tensor.  K6a reads x twice (statistics, apply) and
// writes y once (float32: reads x three times); K6b reads x and dy twice
// and writes dx once.
//
// Design: every launch runs on the caller's stream, allocates nothing,
// and uses no atomics, so every result is bitwise repeatable.
//   - A block of 256 threads covers a tile of channels: tpr threads a
//     row, each on VEC channels (16-byte vector loads: 8 of bf16/f16, 4
//     of float32, where C and the pointers allow; else one scalar), and
//     256 / tpr rows at a time.  A row split gives each block a fixed
//     range of rows (ops/batch_norm.py launch_plan: about four blocks an
//     SM at both ends of ResNet-50, the stem's M = 1,605,632 x C = 64 and
//     layer 4's M = 6,272 x C = 2,048); each thread keeps its sums in
//     registers over four rows in flight, then the block adds its rows
//     in a fixed tree in shared memory and writes one partial a channel.
//   - A finishing launch gives each channel a warp: its lanes add the
//     partials of the splits in order, a fixed shuffle tree adds the
//     lanes, and lane 0 works out the per-channel coefficients (and the
//     running statistics); nothing else is ordered by timing.
//   - An apply launch, on the same row partition, reads the per-channel
//     coefficients once a thread and streams the rows.
// The arithmetic of the apply passes uses the _rn intrinsics, so nothing
// is contracted into an FMA and each operation rounds where the plain
// version's does: y and dx equal the plain version wherever the
// statistics agree.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // rows a thread keeps in flight
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float tof(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T fromf(float v);
template <>
__device__ __forceinline__ float fromf<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half fromf<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and widened again
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return tof(fromf<T>(v));
}

// a parameter (gamma, beta and their gradients) of dtype code 0 float32,
// 1 bfloat16, 2 float16
__device__ __forceinline__ float load_param(const void* p, int code, int c) {
  if (code == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]);
  if (code == 2) return __half2float(static_cast<const __half*>(p)[c]);
  return static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void store_param(void* p, int code, int c,
                                            float v) {
  if (code == 1)
    static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16_rn(v);
  else if (code == 2)
    static_cast<__half*>(p)[c] = __float2half_rn(v);
  else
    static_cast<float*>(p)[c] = v;
}

// VEC consecutive elements, loaded and stored as one access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The row partition of a launch: split b owns rows [b * rows, (b + 1) *
// rows) of M; channel tile blockIdx.y owns tpr * VEC channels.
struct Geometry {
  int m, c, tpr, splits, rows;
};

// the end of the rows of the split that starts at r_begin
__device__ __forceinline__ int64_t row_end(const Geometry& g,
                                           int64_t r_begin) {
  const int64_t e = r_begin + g.rows;
  return e < g.m ? e : static_cast<int64_t>(g.m);
}

// what a sums pass adds per channel
enum SumKind {
  kSumSq = 0,     // sum x, sum x^2 (bf16/f16 statistics)
  kSum = 1,       // sum x (float32, first pass)
  kCentered = 2,  // sum (x - center)^2 (float32, second pass)
  kGrad = 3,      // sum dy, sum dy (x - center) (backward)
};

// Partial sums of one row split and channel tile, into
// part[(k * C + c) * splits + split] for k = 0 (and 1 where the kind has
// a second sum).
template <typename T, int VEC, int KIND>
__device__ __forceinline__ void sums_body(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          const float* __restrict__ center,
                                          float* __restrict__ part,
                                          const Geometry& g) {
  constexpr bool kTwo = KIND == kSumSq || KIND == kGrad;
  __shared__ float red[kTwo ? 2 : 1][kThreads * VEC];
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (blockIdx.y * g.tpr + col) * VEC;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * g.rows;
  const int64_t r_end = row_end(g, r_begin);
  float s1[VEC], s2[VEC], mu[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = mu[j] = 0.f;
  if (c0 < g.c) {
    if (KIND == kCentered || KIND == kGrad) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) mu[j] = center[c0 + j];
    }
    auto add = [&](const Pack<T, VEC>& pa, const Pack<T, VEC>& pb) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = tof(pa.v[j]);
        if (KIND == kSumSq) {
          s1[j] += v;
          s2[j] = __fmaf_rn(v, v, s2[j]);
        } else if (KIND == kSum) {
          s1[j] += v;
        } else if (KIND == kCentered) {
          const float d = __fsub_rn(v, mu[j]);
          s1[j] = __fmaf_rn(d, d, s1[j]);
        } else {
          const float dy = tof(pb.v[j]);
          s1[j] += dy;
          s2[j] = __fmaf_rn(dy, __fsub_rn(v, mu[j]), s2[j]);
        }
      }
    };
    int64_t r = r_begin + row0;
    for (; r + (kUnroll - 1) * rpi < r_end; r += kUnroll * rpi) {
      Pack<T, VEC> pa[kUnroll], pb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t off = (r + u * rpi) * g.c + c0;
        pa[u] = *reinterpret_cast<const Pack<T, VEC>*>(a + off);
        if (KIND == kGrad)
          pb[u] = *reinterpret_cast<const Pack<T, VEC>*>(b + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(pa[u], pb[u]);
    }
    for (; r < r_end; r += rpi) {
      const int64_t off = r * g.c + c0;
      Pack<T, VEC> pa = *reinterpret_cast<const Pack<T, VEC>*>(a + off);
      Pack<T, VEC> pb;
      if (KIND == kGrad) pb = *reinterpret_cast<const Pack<T, VEC>*>(b + off);
      add(pa, pb);
    }
  }
  // the block's rows, added in a fixed tree
  const int slot = row0 * (g.tpr * VEC) + col * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[0][slot + j] = s1[j];
    if (kTwo) red[kTwo ? 1 : 0][slot + j] = s2[j];
  }
  for (int s = rpi / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (row0 < s) {
      const int other = slot + s * (g.tpr * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[0][slot + j] += red[0][other + j];
        if (kTwo) red[kTwo ? 1 : 0][slot + j] += red[kTwo ? 1 : 0][other + j];
      }
    }
  }
  if (row0 == 0 && c0 < g.c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int64_t c = c0 + j;
      part[c * g.splits + blockIdx.x] = red[0][slot + j];
      if (kTwo)
        part[(g.c + c) * g.splits + blockIdx.x] = red[kTwo ? 1 : 0][slot + j];
    }
  }
}

// the forward's statistics (K6a) and the backward's sums (K6b), as two
// kernels so that a trace tells them apart by name
template <typename T, int VEC, int KIND>
__global__ void __launch_bounds__(kThreads)
    bn_stat_sums_kernel(const T* __restrict__ x,
                        const float* __restrict__ center,
                        float* __restrict__ part, Geometry g) {
  sums_body<T, VEC, KIND>(x, nullptr, center, part, g);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ center,
                        float* __restrict__ part, Geometry g) {
  sums_body<T, VEC, kGrad>(x, dy, center, part, g);
}

// The sum over the splits of partial k of channel c, on every lane of
// the warp (lane 0's value is the one used): lane l adds splits l, l +
// 32, ... in order, then a fixed butterfly adds the lanes.
__device__ __forceinline__ float split_sum(const float* part, int k, int c,
                                           int cs, int splits) {
  const int lane = threadIdx.x % 32;
  const float* p = part + (static_cast<int64_t>(k) * cs + c) * splits;
  float v = 0.f;
  for (int s = lane; s < splits; s += 32) v += p[s];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// per-channel state of the forward, float32 (4, C): the mean and the
// scale and shift as the apply pass uses them (each a value of the data's
// type), and inv = rsqrt(var + eps)
enum StatRow { kMean = 0, kScale = 1, kShift = 2, kInv = 3 };

struct FwdArgs {
  int m, c, splits;
  int phase;        // 0: float32 mean only; 1: everything
  int mode;         // 0 train, 1 train and update the running statistics,
                    // 2 predict (running statistics)
  int fix_gamma, gamma_code, beta_code;
  float eps, momentum, one_minus_m;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_finish_kernel(const float* __restrict__ part,
                         const void* __restrict__ gamma,
                         const void* __restrict__ beta, float* rmean,
                         float* rvar, T* __restrict__ mean_out,
                         T* __restrict__ var_out, float* __restrict__ stats,
                         FwdArgs a) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= a.c) return;
  const bool half = sizeof(T) == 2;
  const float fm = static_cast<float>(a.m);
  float mean_d, var_d;
  if (a.mode == 2) {
    if (threadIdx.x % 32) return;
    mean_d = rnd<T>(rmean[c]);
    var_d = rvar[c];  // used as it is, not rounded
  } else if (half) {
    const float s1 = split_sum(part, 0, c, a.c, a.splits);
    const float s2 = split_sum(part, 1, c, a.c, a.splits);
    if (threadIdx.x % 32) return;
    const float mean = __fdiv_rn(s1, fm);
    const float meansq = __fdiv_rn(s2, fm);
    float var = __fsub_rn(meansq, __fmul_rn(mean, mean));
    if (var < 0.f) var = 0.f;  // a NaN stays NaN, as torch.clamp_min keeps it
    mean_d = rnd<T>(mean);
    var_d = rnd<T>(var);
  } else if (a.phase == 0) {
    const float s1 = split_sum(part, 0, c, a.c, a.splits);
    if (threadIdx.x % 32 == 0) stats[kMean * a.c + c] = __fdiv_rn(s1, fm);
    return;
  } else {
    const float s2 = split_sum(part, 0, c, a.c, a.splits);
    if (threadIdx.x % 32) return;
    mean_d = stats[kMean * a.c + c];
    var_d = __fdiv_rn(s2, fm);
  }
  const float inv = rsqrtf(__fadd_rn(var_d, a.eps));
  const float g = a.fix_gamma ? 1.f : load_param(gamma, a.gamma_code, c);
  stats[kMean * a.c + c] = mean_d;
  stats[kScale * a.c + c] = rnd<T>(__fmul_rn(g, inv));
  stats[kShift * a.c + c] = rnd<T>(load_param(beta, a.beta_code, c));
  stats[kInv * a.c + c] = inv;
  if (a.mode == 2) return;
  mean_out[c] = fromf<T>(mean_d);
  var_out[c] = fromf<T>(var_d);
  if (a.mode == 1) {
    rmean[c] = __fadd_rn(__fmul_rn(rmean[c], a.momentum),
                         rnd<T>(__fmul_rn(mean_d, a.one_minus_m)));
    rvar[c] = __fadd_rn(__fmul_rn(rvar[c], a.momentum),
                        rnd<T>(__fmul_rn(var_d, a.one_minus_m)));
  }
}

// y = ((x - mean) * scale) + shift, each operation rounded to T
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_apply_fwd_kernel(const T* __restrict__ x,
                        const float* __restrict__ stats, T* __restrict__ y,
                        Geometry g) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (blockIdx.y * g.tpr + col) * VEC;
  if (c0 >= g.c) return;
  float mu[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = stats[kMean * g.c + c0 + j];
    sc[j] = stats[kScale * g.c + c0 + j];
    sh[j] = stats[kShift * g.c + c0 + j];
  }
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * g.rows;
  const int64_t r_end = row_end(g, r_begin);
  auto apply = [&](const Pack<T, VEC>& in, Pack<T, VEC>& out) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = rnd<T>(__fsub_rn(tof(in.v[j]), mu[j]));
      const float s = rnd<T>(__fmul_rn(t, sc[j]));
      out.v[j] = fromf<T>(__fadd_rn(s, sh[j]));
    }
  };
  int64_t r = r_begin + row0;
  for (; r + (kUnroll - 1) * rpi < r_end; r += kUnroll * rpi) {
    Pack<T, VEC> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      in[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + (r + u * rpi) * g.c +
                                                     c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Pack<T, VEC> out;
      apply(in[u], out);
      *reinterpret_cast<Pack<T, VEC>*>(y + (r + u * rpi) * g.c + c0) = out;
    }
  }
  for (; r < r_end; r += rpi) {
    Pack<T, VEC> out;
    apply(*reinterpret_cast<const Pack<T, VEC>*>(x + r * g.c + c0), out);
    *reinterpret_cast<Pack<T, VEC>*>(y + r * g.c + c0) = out;
  }
}

// per-channel coefficients of the backward, float32 (3, C):
// dx = k1 (dy - k2) - k3 (x - mean)
enum CoefRow { kK1 = 0, kK2 = 1, kK3 = 2 };

struct BwdArgs {
  int m, c, splits;
  int train, fix_gamma, gamma_code, beta_code;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_finish_kernel(const float* __restrict__ part,
                         const float* __restrict__ stats,
                         const void* __restrict__ gamma, void* dgamma,
                         void* dbeta, float* __restrict__ coef, BwdArgs a) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= a.c) return;
  const float sdy = split_sum(part, 0, c, a.c, a.splits);
  const float sdxm = split_sum(part, 1, c, a.c, a.splits);
  if (threadIdx.x % 32) return;
  const float inv = stats[kInv * a.c + c];
  if (dbeta != nullptr) store_param(dbeta, a.beta_code, c, sdy);
  if (dgamma != nullptr)
    store_param(dgamma, a.gamma_code, c,
                a.fix_gamma ? 0.f : __fmul_rn(inv, sdxm));
  float k2 = 0.f, k3 = 0.f;
  if (a.train) {
    const float fm = static_cast<float>(a.m);
    const float g = a.fix_gamma ? 1.f : load_param(gamma, a.gamma_code, c);
    k2 = __fdiv_rn(sdy, fm);
    k3 = __fdiv_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(g, inv), __fmul_rn(inv, inv)), sdxm),
        fm);
  }
  coef[kK1 * a.c + c] = stats[kScale * a.c + c];
  coef[kK2 * a.c + c] = k2;
  coef[kK3 * a.c + c] = k3;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_apply_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ stats,
                        const float* __restrict__ coef, T* __restrict__ dx,
                        Geometry g) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (blockIdx.y * g.tpr + col) * VEC;
  if (c0 >= g.c) return;
  float mu[VEC], k1[VEC], k2[VEC], k3[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = stats[kMean * g.c + c0 + j];
    k1[j] = coef[kK1 * g.c + c0 + j];
    k2[j] = coef[kK2 * g.c + c0 + j];
    k3[j] = coef[kK3 * g.c + c0 + j];
  }
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * g.rows;
  const int64_t r_end = row_end(g, r_begin);
  auto apply = [&](const Pack<T, VEC>& px, const Pack<T, VEC>& pd,
                   Pack<T, VEC>& out) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = __fmul_rn(k1[j], __fsub_rn(tof(pd.v[j]), k2[j]));
      const float u = __fmul_rn(k3[j], __fsub_rn(tof(px.v[j]), mu[j]));
      out.v[j] = fromf<T>(__fsub_rn(t, u));
    }
  };
  int64_t r = r_begin + row0;
  for (; r + (kUnroll - 1) * rpi < r_end; r += kUnroll * rpi) {
    Pack<T, VEC> px[kUnroll], pd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = (r + u * rpi) * g.c + c0;
      px[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
      pd[u] = *reinterpret_cast<const Pack<T, VEC>*>(dy + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Pack<T, VEC> out;
      apply(px[u], pd[u], out);
      *reinterpret_cast<Pack<T, VEC>*>(dx + (r + u * rpi) * g.c + c0) = out;
    }
  }
  for (; r < r_end; r += rpi) {
    const int64_t off = r * g.c + c0;
    Pack<T, VEC> out;
    apply(*reinterpret_cast<const Pack<T, VEC>*>(x + off),
          *reinterpret_cast<const Pack<T, VEC>*>(dy + off), out);
    *reinterpret_cast<Pack<T, VEC>*>(dx + off) = out;
  }
}

bool valid(const Geometry& g, int vec) {
  if (g.m < 1 || g.c < 1 || g.splits < 1 || g.rows < 1) return false;
  if (static_cast<int64_t>(g.splits) * g.rows < g.m) return false;
  if (g.tpr < 1 || g.tpr > 32 || (g.tpr & (g.tpr - 1))) return false;
  return vec == 1 || g.c % vec == 0;
}

dim3 row_grid(const Geometry& g, int vec) {
  const int per_tile = g.tpr * vec;
  return dim3(g.splits, (g.c + per_tile - 1) / per_tile);
}

dim3 channel_grid(int c) { return dim3((c + kWarps - 1) / kWarps); }

template <typename T, int VEC>
int fwd_typed(const void* x, const void* gamma, const void* beta,
              float* rmean, float* rvar, void* y, void* mean_out,
              void* var_out, float* stats, float* ws, const Geometry& g,
              FwdArgs a, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid = row_grid(g, VEC);
  if (a.mode != 2) {
    if constexpr (sizeof(T) == 2) {
      bn_stat_sums_kernel<T, VEC, kSumSq><<<grid, kThreads, 0, st>>>(
          xt, nullptr, ws, g);
    } else {
      bn_stat_sums_kernel<T, VEC, kSum><<<grid, kThreads, 0, st>>>(
          xt, nullptr, ws, g);
      a.phase = 0;
      bn_fwd_finish_kernel<T><<<channel_grid(g.c), kThreads, 0, st>>>(
          ws, gamma, beta, rmean, rvar, static_cast<T*>(mean_out),
          static_cast<T*>(var_out), stats, a);
      bn_stat_sums_kernel<T, VEC, kCentered><<<grid, kThreads, 0, st>>>(
          xt, stats + kMean * g.c, ws, g);
    }
  }
  a.phase = 1;
  bn_fwd_finish_kernel<T><<<channel_grid(g.c), kThreads, 0, st>>>(
      ws, gamma, beta, rmean, rvar, static_cast<T*>(mean_out),
      static_cast<T*>(var_out), stats, a);
  bn_apply_fwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      xt, stats, static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T>
int fwd_dispatch(const void* x, const void* gamma, const void* beta,
                 float* rmean, float* rvar, void* y, void* mean_out,
                 void* var_out, float* stats, float* ws, const Geometry& g,
                 int vec, const FwdArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return fwd_typed<T, kVec>(x, gamma, beta, rmean, rvar, y, mean_out,
                              var_out, stats, ws, g, a, st);
  if (vec == 1)
    return fwd_typed<T, 1>(x, gamma, beta, rmean, rvar, y, mean_out, var_out,
                           stats, ws, g, a, st);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
int bwd_typed(const void* x, const void* dy, const float* stats,
              const void* gamma, void* dx, void* dgamma, void* dbeta,
              float* ws, const Geometry& g, const BwdArgs& a,
              cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  float* coef = ws + static_cast<int64_t>(2) * g.c * g.splits;
  const dim3 grid = row_grid(g, VEC);
  bn_grad_sums_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      xt, dyt, stats + kMean * g.c, ws, g);
  bn_bwd_finish_kernel<T><<<channel_grid(g.c), kThreads, 0, st>>>(
      ws, stats, gamma, dgamma, dbeta, coef, a);
  bn_apply_bwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      xt, dyt, stats, coef, static_cast<T*>(dx), g);
  return cudaGetLastError();
}

template <typename T>
int bwd_dispatch(const void* x, const void* dy, const float* stats,
                 const void* gamma, void* dx, void* dgamma, void* dbeta,
                 float* ws, const Geometry& g, int vec, const BwdArgs& a,
                 cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return bwd_typed<T, kVec>(x, dy, stats, gamma, dx, dgamma, dbeta, ws, g,
                              a, st);
  if (vec == 1)
    return bwd_typed<T, 1>(x, dy, stats, gamma, dx, dgamma, dbeta, ws, g, a,
                           st);
  return cudaErrorInvalidValue;
}

bool valid_code(int code) { return code >= 0 && code <= 2; }

}  // namespace

// K6a.  x and y (M, C) of dtype code `dtype`; gamma and beta (C,) of
// their own codes; rmean and rvar (C,) float32, read in predict mode
// (mode 2) and updated in place in mode 1; mean_out and var_out (C,) of
// x's type, written in train mode; stats (4, C) float32, written for the
// backward; ws holds 2 * C * splits floats of partial sums.
extern "C" int mxt_bn_fwd(const void* x, const void* gamma, const void* beta,
                          float* rmean, float* rvar, void* y, void* mean_out,
                          void* var_out, float* stats, float* ws, int m, int c,
                          int vec, int tpr, int splits, int rows, int dtype,
                          int gamma_code, int beta_code, int mode,
                          int fix_gamma, float eps, float momentum,
                          float one_minus_m, void* stream) {
  const Geometry g{m, c, tpr, splits, rows};
  if (!valid(g, vec) || mode < 0 || mode > 2 || !valid_code(gamma_code) ||
      !valid_code(beta_code))
    return cudaErrorInvalidValue;
  const FwdArgs a{m,         c,         splits,   1,   mode,
                  fix_gamma, gamma_code, beta_code, eps, momentum,
                  one_minus_m};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_dispatch<float>(x, gamma, beta, rmean, rvar, y, mean_out,
                               var_out, stats, ws, g, vec, a, st);
  if (dtype == 1)
    return fwd_dispatch<__nv_bfloat16>(x, gamma, beta, rmean, rvar, y,
                                       mean_out, var_out, stats, ws, g, vec,
                                       a, st);
  if (dtype == 2)
    return fwd_dispatch<__half>(x, gamma, beta, rmean, rvar, y, mean_out,
                                var_out, stats, ws, g, vec, a, st);
  return cudaErrorInvalidValue;
}

// K6b.  x, dy and dx (M, C) of dtype code `dtype`; stats (4, C) from
// K6a; gamma (C,) of gamma_code; dgamma and dbeta (C,) of the codes of
// gamma and beta, or null where no gradient is wanted; ws holds
// 2 * C * splits + 3 * C floats.
extern "C" int mxt_bn_bwd(const void* x, const void* dy, const float* stats,
                          const void* gamma, void* dx, void* dgamma,
                          void* dbeta, float* ws, int m, int c, int vec,
                          int tpr, int splits, int rows, int dtype,
                          int gamma_code, int beta_code, int train,
                          int fix_gamma, void* stream) {
  const Geometry g{m, c, tpr, splits, rows};
  if (!valid(g, vec) || !valid_code(gamma_code) || !valid_code(beta_code))
    return cudaErrorInvalidValue;
  const BwdArgs a{m, c, splits, train, fix_gamma, gamma_code, beta_code};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dispatch<float>(x, dy, stats, gamma, dx, dgamma, dbeta, ws, g,
                               vec, a, st);
  if (dtype == 1)
    return bwd_dispatch<__nv_bfloat16>(x, dy, stats, gamma, dx, dgamma, dbeta,
                                       ws, g, vec, a, st);
  if (dtype == 2)
    return bwd_dispatch<__half>(x, dy, stats, gamma, dx, dgamma, dbeta, ws, g,
                                vec, a, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
