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
// pass streams the tensor.  K6a's bound is x read once and y written
// once, K6b's x and dy read once and dx written once; each moves that
// where its slab stays on the chip, else reads its inputs again but for
// what shared memory and the L2 keep (K6a in float32 reads x a third
// time, for the centered sums).
//
// Design: every launch runs on the caller's stream, allocates nothing,
// and uses no atomics in its sums, so every result is bitwise repeatable.
//   - A block of 256 threads covers a tile of channels: tpr threads a
//     row, each on VEC channels (16-byte vector loads: 8 of bf16/f16, 4
//     of float32, where C and the pointers allow; else one scalar), and
//     256 / tpr rows at a time.  A row split gives each (split, channel
//     tile) item a fixed range of rows (ops/batch_norm.py launch_plan:
//     about four items an SM of an H100 at both ends of ResNet-50, the
//     stem's M = 1,605,632 x C = 64 and layer 4's M = 6,272 x C = 2,048);
//     each thread keeps its sums in registers over four rows in flight,
//     then the block adds its rows in a fixed tree in shared memory and
//     writes one partial a channel.
//   - K6a and K6b are each one cooperative launch of co-resident blocks
//     (bn_fwd_kernel, bn_bwd_kernel) over that partition: the partial
//     sums, a grid barrier, each channel finished by one warp of the grid
//     (its lanes add the partials of the splits in order, a fixed shuffle
//     tree adds the lanes, lane 0 works out the channel's state), a
//     second barrier, then y or dx.  K6a finishes the per-channel state
//     and the running statistics, K6b dgamma, dbeta and three
//     coefficients a channel; K6a in float32 finishes the mean first and
//     sums (x - mean)^2 between two more barriers.  Both keep the row
//     partition, order and tree of the earlier three-launch designs, so
//     their results are those designs' bit for bit.
//   - Routes, from the shapes alone (ops/batch_norm.py launch_plan, passed
//     in with the geometry).  "streamed": at most four blocks an SM walk
//     the items; where a block has one item, each thread keeps the first
//     rounds of its rows (K6a: ten of x in bf16 and float16, thirteen in
//     float32; K6b: five or six of x and dy) in the shared memory that
//     four blocks an SM leave, and the last phase reads the rest again,
//     last row first, so that what phase 1 read last is still in the 50 MB
//     L2.  K6a streams at every shape.  K6b takes "resident" where every
//     block's rows of x and dy fit in shared memory with all blocks
//     co-resident: a block takes a group of consecutive splits of one
//     tile, phase 1 copies its rows there by cp.async, eight rounds in
//     flight, and phase 2 reads them from there, so the inputs cross HBM
//     once.  K6a's x alone would fit at more shapes, but every such tensor
//     also fits in the L2, which the streamed second read hits: on an H100
//     a resident K6a moved the ResNet-50 step by less than its spread
//     between turns.  At the small shapes the two grid barriers, about
//     2 us each at 524 blocks, cost more than the kernel boundaries of the
//     three-launch design.
//     mxt_bn_fwd_occupancy and mxt_bn_bwd_occupancy let the wrapper hold
//     a plan to the occupancy API.  The barriers are cooperative_groups'
//     grid sync; the launch is refused, and the wrapper raises, where the
//     grid is not co-resident.
// The arithmetic of the apply phases uses the _rn intrinsics, so nothing
// is contracted into an FMA and each operation rounds where the plain
// version's does: y and dx equal the plain version wherever the
// statistics agree.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // rows a thread keeps in flight
// rows in flight in K6b's streamed phase 2, whose coefficients take 32
// registers (a thread's 64, at four blocks an SM) beside them
constexpr int kApplyUnroll = 2;
constexpr int kWarps = kThreads / 32;
// the co-resident blocks an SM that ops/batch_norm.py launch_plan assumes
// for the streamed routes (the launch bounds keep the registers to 64 a
// thread for it; the wrapper holds each plan to the occupancy API), and a
// round of a block's slab: 16 bytes a thread of x (K6a), of x and dy (K6b)
constexpr int kBlocksPerSm = 4;
constexpr int kFwdRoundBytes = kThreads * 16;
constexpr int kBwdRoundBytes = 2 * kThreads * 16;
constexpr int kStages = 8;                      // rounds of cp.async in flight

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

// The block's per-thread sums s1 (and s2 where kTwo) added over its rows
// in a fixed tree in shared memory, and written as the partial of split
// `split`: part[(k * C + c) * splits + split].
template <int VEC, bool kTwo>
__device__ __forceinline__ void block_partials(const float (&s1)[VEC],
                                               const float (&s2)[VEC],
                                               float* __restrict__ part,
                                               const Geometry& g, int split,
                                               int c0) {
  __shared__ float red[kTwo ? 2 : 1][kThreads * VEC];
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int rpi = kThreads / g.tpr;
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
      part[c * g.splits + split] = red[0][slot + j];
      if (kTwo)
        part[(g.c + c) * g.splits + split] = red[kTwo ? 1 : 0][slot + j];
    }
  }
  __syncthreads();  // red is free for the block's next item
}

// A pack of x (and of dy, for kGrad) added into the thread's sums, in
// the order the rows come.
template <typename T, int VEC, int KIND>
__device__ __forceinline__ void accumulate(float (&s1)[VEC], float (&s2)[VEC],
                                           const float (&mu)[VEC],
                                           const Pack<T, VEC>& pa,
                                           const Pack<T, VEC>& pb) {
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
}

// Partial sums of one row split and channel tile, into
// part[(k * C + c) * splits + split] for k = 0 (and 1 where the kind has
// a second sum).  The streamed routes keep the thread's first `keep`
// rounds of rows of x (and dy, for kGrad) in its slots of `slab`: copied
// there by cp.async and summed first where `copy` (the row order stays),
// else (K6a's centered float32 sums) summed from there, for the last
// phase to read from there too.
template <typename T, int VEC, int KIND>
__device__ __forceinline__ void sums_body(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          const float* __restrict__ center,
                                          float* __restrict__ part,
                                          const Geometry& g, int split,
                                          int tile, int keep = 0,
                                          uint4* slab = nullptr,
                                          bool copy = true) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (tile * g.tpr + col) * VEC;
  const int64_t r_begin = static_cast<int64_t>(split) * g.rows;
  const int64_t r_end = row_end(g, r_begin);
  float s1[VEC], s2[VEC], mu[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = mu[j] = 0.f;
  if (c0 < g.c) {
    if (KIND == kCentered || KIND == kGrad) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) mu[j] = center[c0 + j];
    }
    int64_t r = r_begin + row0;
    if constexpr (sizeof(T) * VEC == 16) {
      uint4* sa = slab + threadIdx.x;
      uint4* sb = slab + keep * kThreads + threadIdx.x;
      if (copy) {
        for (int i = 0; i < keep && r + i * rpi < r_end; ++i) {
          const int64_t off = (r + i * rpi) * g.c + c0;
          cp_async16(smem_u32(sa + i * kThreads), a + off, true);
          if (KIND == kGrad)
            cp_async16(smem_u32(sb + i * kThreads), b + off, true);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      for (int i = 0; i < keep && r < r_end; ++i, r += rpi)
        accumulate<T, VEC, KIND>(
            s1, s2, mu,
            *reinterpret_cast<const Pack<T, VEC>*>(sa + i * kThreads),
            *reinterpret_cast<const Pack<T, VEC>*>(
                (KIND == kGrad ? sb : sa) + i * kThreads));
    }
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
      for (int u = 0; u < kUnroll; ++u)
        accumulate<T, VEC, KIND>(s1, s2, mu, pa[u],
                                 KIND == kGrad ? pb[u] : pa[u]);
    }
    for (; r < r_end; r += rpi) {
      const int64_t off = r * g.c + c0;
      Pack<T, VEC> pa = *reinterpret_cast<const Pack<T, VEC>*>(a + off);
      Pack<T, VEC> pb = pa;
      if (KIND == kGrad) pb = *reinterpret_cast<const Pack<T, VEC>*>(b + off);
      accumulate<T, VEC, KIND>(s1, s2, mu, pa, pb);
    }
  }
  block_partials<VEC, KIND == kSumSq || KIND == kGrad>(s1, s2, part, g,
                                                       split, c0);
}

// The sum over the splits of partial k of channel c, on every lane of
// the warp (lane 0's value is the one used): lane l adds splits l, l +
// 32, ... in order, then a fixed butterfly adds the lanes.
__device__ __forceinline__ float split_sum(const float* part, int k, int c,
                                           int cs, int splits) {
  const int lane = threadIdx.x % 32;
  const float* p = part + (static_cast<int64_t>(k) * cs + c) * splits;
  float v = 0.f;
  for (int s = lane; s < splits; s += 32) v += __ldcg(p + s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// per-channel state of the forward, float32 (4, C): the mean and the
// scale and shift as the apply phase uses them (each a value of the data's
// type), and inv = rsqrt(var + eps)
enum StatRow { kMean = 0, kScale = 1, kShift = 2, kInv = 3 };

struct FwdArgs {
  int m, c, splits;
  int mode;         // 0 train, 1 train and update the running statistics,
                    // 2 predict (running statistics)
  int fix_gamma, gamma_code, beta_code;
  float eps, momentum, one_minus_m;
};

// K6a in float32: the mean of channel c, by one whole warp, into stats
// (the centered sums read it after a grid barrier).
__device__ __forceinline__ void fwd_mean_channel(const float* part,
                                                 float* __restrict__ stats,
                                                 const FwdArgs& a, int c) {
  const float s1 = split_sum(part, 0, c, a.c, a.splits);
  if (threadIdx.x % 32 == 0)
    stats[kMean * a.c + c] = __fdiv_rn(s1, static_cast<float>(a.m));
}

// The finish of channel c, by one whole warp: the sums of its partials
// over the splits (the fixed order and tree of split_sum; in predict mode
// the running statistics), then, on lane 0, the channel's state, its
// mean and var, and the running statistics.
template <typename T>
__device__ __forceinline__ void fwd_finish_channel(
    const float* part, const void* __restrict__ gamma,
    const void* __restrict__ beta, float* rmean, float* rvar, T* mean_out,
    T* var_out, float* __restrict__ stats, const FwdArgs& a, int c) {
  const float fm = static_cast<float>(a.m);
  float mean_d, var_d;
  if (a.mode == 2) {
    if (threadIdx.x % 32) return;
    mean_d = rnd<T>(rmean[c]);
    var_d = rvar[c];  // used as it is, not rounded
  } else if (sizeof(T) == 2) {
    const float s1 = split_sum(part, 0, c, a.c, a.splits);
    const float s2 = split_sum(part, 1, c, a.c, a.splits);
    if (threadIdx.x % 32) return;
    const float mean = __fdiv_rn(s1, fm);
    const float meansq = __fdiv_rn(s2, fm);
    float var = __fsub_rn(meansq, __fmul_rn(mean, mean));
    if (var < 0.f) var = 0.f;  // a NaN stays NaN, as torch.clamp_min keeps it
    mean_d = rnd<T>(mean);
    var_d = rnd<T>(var);
  } else {
    const float s2 = split_sum(part, 0, c, a.c, a.splits);
    if (threadIdx.x % 32) return;
    mean_d = stats[kMean * a.c + c];  // this lane's fwd_mean_channel
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

// the state of a thread's VEC channels, and y = ((x - mean) * scale) +
// shift of one element pack, each operation rounded to T.  Read after the
// grid barrier with plain loads, as K6b's coefficients are (BwdCoefs).
template <int VEC>
struct FwdState {
  float mu[VEC], sc[VEC], sh[VEC];

  __device__ __forceinline__ void load(const float* stats, int c, int c0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = stats[kMean * c + c0 + j];
      sc[j] = stats[kScale * c + c0 + j];
      sh[j] = stats[kShift * c + c0 + j];
    }
  }

  template <typename T>
  __device__ __forceinline__ Pack<T, VEC> y(const Pack<T, VEC>& in) const {
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = rnd<T>(__fsub_rn(tof(in.v[j]), mu[j]));
      const float s = rnd<T>(__fmul_rn(t, sc[j]));
      out.v[j] = fromf<T>(__fadd_rn(s, sh[j]));
    }
    return out;
  }
};

// per-channel coefficients of the backward, float32 (3, C):
// dx = k1 (dy - k2) - k3 (x - mean)
enum CoefRow { kK1 = 0, kK2 = 1, kK3 = 2 };

struct BwdArgs {
  int m, c, splits;
  int train, fix_gamma, gamma_code, beta_code;
};

// The finish of channel c, by one whole warp: the sums of its partials
// over the splits (the fixed order and tree of split_sum), then, on lane
// 0, dgamma, dbeta and the channel's coefficients.
__device__ __forceinline__ void bwd_finish_channel(
    const float* part, const float* __restrict__ stats,
    const void* __restrict__ gamma, void* dgamma, void* dbeta, float* coef,
    const BwdArgs& a, int c) {
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

// the coefficients of a thread's VEC channels, and dx of one element pack,
// rounded once to T.  The coefficients are read after the grid barrier,
// whose acquire orders these loads after the finish's stores.  They are
// plain loads, which the compiler vectorizes: L2-only __ldcg loads of
// them cost 1.0 of the 6.4 ms that K6b took over a ResNet-50 step on an
// H100.
template <int VEC>
struct BwdCoefs {
  float mu[VEC], k1[VEC], k2[VEC], k3[VEC];

  __device__ __forceinline__ void load(const float* __restrict__ stats,
                                       const float* coef, int c, int c0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = stats[kMean * c + c0 + j];
      k1[j] = coef[kK1 * c + c0 + j];
      k2[j] = coef[kK2 * c + c0 + j];
      k3[j] = coef[kK3 * c + c0 + j];
    }
  }

  template <typename T>
  __device__ __forceinline__ Pack<T, VEC> dx(const Pack<T, VEC>& px,
                                             const Pack<T, VEC>& pd) const {
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = __fmul_rn(k1[j], __fsub_rn(tof(pd.v[j]), k2[j]));
      const float u = __fmul_rn(k3[j], __fsub_rn(tof(px.v[j]), mu[j]));
      out.v[j] = fromf<T>(__fsub_rn(t, u));
    }
    return out;
  }
};

// K6b's "resident" route: a block owns `spb` consecutive row splits of
// one channel tile (a group), `rps` rounds of rows a split for each
// thread.  Phase 1 copies the thread's rows of x and dy by cp.async into
// its own slots of the block's slab (x rounds first, then dy rounds; slot
// i * 256 + thread of each, round i = split * rps + k), kStages rounds in
// flight, sums them as they land in row order as sums_body does, and
// writes each split's partial: the same partials, in the same order, as
// the streamed route.  Each thread reads only the slots it copied itself,
// so the slab needs no block barrier; it stays for phase 2.
struct Group {
  int s0, nsplit, tile;
};

__device__ __forceinline__ Group resident_group(const Geometry& g, int spb) {
  const int groups = (g.splits + spb - 1) / spb;
  Group gr;
  gr.s0 = (blockIdx.x % groups) * spb;
  gr.nsplit = min(spb, g.splits - gr.s0);
  gr.tile = blockIdx.x / groups;
  return gr;
}

template <typename T, int VEC>
__device__ __forceinline__ void resident_sums(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ mean, float* __restrict__ part,
    const Geometry& g, const Group& gr, int rps, int rounds, uint4* slab) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (gr.tile * g.tpr + col) * VEC;
  const bool active = c0 < g.c;
  const int total = gr.nsplit * rps;
  uint4* sx = slab + threadIdx.x;
  uint4* sd = slab + rounds * kThreads + threadIdx.x;
  float s1[VEC], s2[VEC], mu[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s1[j] = s2[j] = 0.f;
    mu[j] = active ? mean[c0 + j] : 0.f;
  }
  // the row of round i, or -1 where the thread has none
  auto row = [&](int i) -> int64_t {
    const int64_t begin = static_cast<int64_t>(gr.s0 + i / rps) * g.rows;
    const int64_t r = begin + row0 + static_cast<int64_t>(i % rps) * rpi;
    return active && i < total && r < row_end(g, begin) ? r : -1;
  };
  auto issue = [&](int i) {
    const int64_t r = row(i);
    if (r >= 0) {
      const int64_t off = r * g.c + c0;
      cp_async16(smem_u32(sx + i * kThreads), x + off, true);
      cp_async16(smem_u32(sd + i * kThreads), dy + off, true);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < total; ++i) {
    issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    if (row(i) >= 0)
      accumulate<T, VEC, kGrad>(
          s1, s2, mu, *reinterpret_cast<const Pack<T, VEC>*>(sx + i * kThreads),
          *reinterpret_cast<const Pack<T, VEC>*>(sd + i * kThreads));
    if (i % rps == rps - 1) {  // the split's last round: its partial
      block_partials<VEC, true>(s1, s2, part, g, gr.s0 + i / rps, c0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
    }
  }
}

// The "resident" phase 2: dx of the group's rows from the slab.
template <typename T, int VEC>
__device__ __forceinline__ void resident_apply(
    const float* __restrict__ stats, const float* coef, T* __restrict__ dx,
    const Geometry& g, const Group& gr, int rps, int rounds,
    const uint4* slab) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (gr.tile * g.tpr + col) * VEC;
  if (c0 >= g.c) return;
  BwdCoefs<VEC> k;
  k.load(stats, coef, g.c, c0);
  const uint4* sx = slab + threadIdx.x;
  const uint4* sd = slab + rounds * kThreads + threadIdx.x;
  for (int i = 0; i < gr.nsplit * rps; ++i) {
    const int64_t begin = static_cast<int64_t>(gr.s0 + i / rps) * g.rows;
    const int64_t r = begin + row0 + static_cast<int64_t>(i % rps) * rpi;
    if (r >= row_end(g, begin)) continue;
    *reinterpret_cast<Pack<T, VEC>*>(dx + r * g.c + c0) = k.template dx<T>(
        *reinterpret_cast<const Pack<T, VEC>*>(sx + i * kThreads),
        *reinterpret_cast<const Pack<T, VEC>*>(sd + i * kThreads));
  }
}

// The "streamed" phase 2: dx of the item's rows read again from device
// memory, last row first, so that the rows phase 1 read last, still in the
// L2, are read first; then the first `keep` rounds from the slab.
template <typename T, int VEC>
__device__ __forceinline__ void streamed_apply(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ stats, const float* coef, T* __restrict__ dx,
    const Geometry& g, int split, int tile, int keep, const uint4* slab) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (tile * g.tpr + col) * VEC;
  const int64_t first = static_cast<int64_t>(split) * g.rows + row0;
  const int64_t r_end = row_end(g, static_cast<int64_t>(split) * g.rows);
  if (c0 >= g.c || first >= r_end) return;
  BwdCoefs<VEC> k;
  k.load(stats, coef, g.c, c0);
  const int n = static_cast<int>((r_end - first + rpi - 1) / rpi);
  const int kept = n < keep ? n : keep;
  int i = n - 1;
  for (; i >= kept + kApplyUnroll - 1; i -= kApplyUnroll) {
    Pack<T, VEC> px[kApplyUnroll], pd[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int64_t off = (first + static_cast<int64_t>(i - u) * rpi) * g.c +
                          c0;
      px[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
      pd[u] = *reinterpret_cast<const Pack<T, VEC>*>(dy + off);
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int64_t off = (first + static_cast<int64_t>(i - u) * rpi) * g.c +
                          c0;
      *reinterpret_cast<Pack<T, VEC>*>(dx + off) =
          k.template dx<T>(px[u], pd[u]);
    }
  }
  for (; i >= kept; --i) {
    const int64_t off = (first + static_cast<int64_t>(i) * rpi) * g.c + c0;
    *reinterpret_cast<Pack<T, VEC>*>(dx + off) = k.template dx<T>(
        *reinterpret_cast<const Pack<T, VEC>*>(x + off),
        *reinterpret_cast<const Pack<T, VEC>*>(dy + off));
  }
  const uint4* sx = slab + threadIdx.x;
  const uint4* sd = slab + keep * kThreads + threadIdx.x;
  for (; i >= 0; --i) {
    const int64_t off = (first + static_cast<int64_t>(i) * rpi) * g.c + c0;
    *reinterpret_cast<Pack<T, VEC>*>(dx + off) = k.template dx<T>(
        *reinterpret_cast<const Pack<T, VEC>*>(sx + i * kThreads),
        *reinterpret_cast<const Pack<T, VEC>*>(sd + i * kThreads));
  }
}

// K6b: one cooperative launch of co-resident blocks over the row
// partition.  Phase 1 writes the partial sums of each (split, channel
// tile); a grid barrier; each channel is finished by one warp of the grid;
// a second barrier; phase 2 writes dx.  "resident" (kResident): a block
// owns a group of `spb` splits of a tile (`rps` rounds each), its slab
// kept in shared memory between the phases; "streamed": the (split, tile)
// items, item = tile * splits + split, strided over the blocks, phase 2
// walking them (and their rows) backwards, the first `keep` rounds of
// each thread's rows kept in shared memory where a block has one item.
template <typename T, int VEC, bool kResident>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ stats,
                  const void* __restrict__ gamma, T* __restrict__ dx,
                  void* dgamma, void* dbeta, float* ws, Geometry g,
                  BwdArgs a, int tiles, int spb, int rps, int keep) {
  extern __shared__ __align__(16) uint4 slab[];
  cg::grid_group grid = cg::this_grid();
  float* part = ws;
  float* coef = ws + static_cast<int64_t>(2) * g.c * g.splits;
  const int items = g.splits * tiles;
  const float* mean = stats + kMean * g.c;
  if constexpr (kResident) {
    resident_sums<T, VEC>(x, dy, mean, part, g, resident_group(g, spb), rps,
                          spb * rps, slab);
  } else {
    for (int it = blockIdx.x; it < items; it += gridDim.x)
      sums_body<T, VEC, kGrad>(x, dy, mean, part, g, it % g.splits,
                               it / g.splits, keep, slab);
  }
  grid.sync();
  for (int c = blockIdx.x * kWarps + threadIdx.x / 32; c < g.c;
       c += gridDim.x * kWarps)
    bwd_finish_channel(part, stats, gamma, dgamma, dbeta, coef, a, c);
  grid.sync();
  if constexpr (kResident) {
    resident_apply<T, VEC>(stats, coef, dx, g, resident_group(g, spb), rps,
                           spb * rps, slab);
  } else {
    if (blockIdx.x >= items) return;
    for (int it = blockIdx.x + (items - 1 - blockIdx.x) / gridDim.x *
                                   gridDim.x;
         it >= 0; it -= gridDim.x)
      streamed_apply<T, VEC>(x, dy, stats, coef, dx, g, it % g.splits,
                             it / g.splits, keep, slab);
  }
}

// K6a's apply: y of the item's rows, x read again from device
// memory, last row first, so that the rows phase 1 read last, still in
// the L2, are read first; then the first `keep` rounds from the slab.
template <typename T, int VEC>
__device__ __forceinline__ void streamed_fwd_apply(
    const T* __restrict__ x, const float* stats, T* __restrict__ y,
    const Geometry& g, int split, int tile, int keep, const uint4* slab) {
  const int rpi = kThreads / g.tpr;
  const int col = threadIdx.x % g.tpr, row0 = threadIdx.x / g.tpr;
  const int c0 = (tile * g.tpr + col) * VEC;
  const int64_t first = static_cast<int64_t>(split) * g.rows + row0;
  const int64_t r_end = row_end(g, static_cast<int64_t>(split) * g.rows);
  if (c0 >= g.c || first >= r_end) return;
  FwdState<VEC> st;
  st.load(stats, g.c, c0);
  const int n = static_cast<int>((r_end - first + rpi - 1) / rpi);
  const int kept = n < keep ? n : keep;
  int i = n - 1;
  for (; i >= kept + kUnroll - 1; i -= kUnroll) {
    Pack<T, VEC> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      in[u] = *reinterpret_cast<const Pack<T, VEC>*>(
          x + (first + static_cast<int64_t>(i - u) * rpi) * g.c + c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<Pack<T, VEC>*>(
          y + (first + static_cast<int64_t>(i - u) * rpi) * g.c + c0) =
          st.template y<T>(in[u]);
  }
  for (; i >= kept; --i) {
    const int64_t off = (first + static_cast<int64_t>(i) * rpi) * g.c + c0;
    const Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
    *reinterpret_cast<Pack<T, VEC>*>(y + off) = st.template y<T>(in);
  }
  const uint4* sx = slab + threadIdx.x;
  for (; i >= 0; --i) {
    const int64_t off = (first + static_cast<int64_t>(i) * rpi) * g.c + c0;
    const Pack<T, VEC> in =
        *reinterpret_cast<const Pack<T, VEC>*>(sx + i * kThreads);
    *reinterpret_cast<Pack<T, VEC>*>(y + off) = st.template y<T>(in);
  }
}

// K6a: one cooperative launch of co-resident blocks over the row
// partition, on K6b's streamed route.  In train mode phase 1 writes the
// partial sums of each (split, channel tile) (bf16/f16: x and x^2;
// float32: x), and a grid barrier follows; float32 then finishes each
// channel's mean (a warp a channel), a barrier, the centered sums (the
// kept rounds from the slab), a barrier.  Each channel is finished by one
// warp of the grid (predict mode: from the running statistics); a last
// barrier; then the apply writes y.  The items are strided over the
// blocks, the apply walking them (and their rows) backwards, the first
// `keep` rounds of each thread's rows kept in shared memory where a block
// has one item.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bn_fwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                  const void* __restrict__ beta, float* rmean, float* rvar,
                  T* __restrict__ y, T* mean_out, T* var_out, float* stats,
                  float* part, Geometry g, FwdArgs a, int tiles, int keep) {
  extern __shared__ __align__(16) uint4 slab[];
  cg::grid_group grid = cg::this_grid();
  constexpr bool kHalf = sizeof(T) == 2;
  const int items = g.splits * tiles;
  const bool train = a.mode != 2;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int warps = gridDim.x * kWarps;
  if (train) {
    for (int it = blockIdx.x; it < items; it += gridDim.x)
      sums_body<T, VEC, kHalf ? kSumSq : kSum>(
          x, nullptr, nullptr, part, g, it % g.splits, it / g.splits, keep,
          slab);
    grid.sync();
    if constexpr (!kHalf) {
      for (int c = warp; c < g.c; c += warps)
        fwd_mean_channel(part, stats, a, c);
      grid.sync();
      const float* mean = stats + kMean * g.c;
      for (int it = blockIdx.x; it < items; it += gridDim.x)
        sums_body<T, VEC, kCentered>(x, nullptr, mean, part, g,
                                     it % g.splits, it / g.splits, keep, slab,
                                     false);
      grid.sync();
    }
  }
  for (int c = warp; c < g.c; c += warps)
    fwd_finish_channel<T>(part, gamma, beta, rmean, rvar, mean_out, var_out,
                          stats, a, c);
  grid.sync();
  if (blockIdx.x >= items) return;
  for (int it = blockIdx.x + (items - 1 - blockIdx.x) / gridDim.x * gridDim.x;
       it >= 0; it -= gridDim.x)
    streamed_fwd_apply<T, VEC>(x, stats, y, g, it % g.splits, it / g.splits,
                               train ? keep : 0, slab);
}

bool valid(const Geometry& g, int vec) {
  if (g.m < 1 || g.c < 1 || g.splits < 1 || g.rows < 1) return false;
  if (static_cast<int64_t>(g.splits) * g.rows < g.m) return false;
  if (g.tpr < 1 || g.tpr > 32 || (g.tpr & (g.tpr - 1))) return false;
  return vec == 1 || g.c % vec == 0;
}

// K6a's kernel (streamed; kResident false) and K6b's kernel of a route
template <bool kFwd, typename T, int VEC, bool kResident>
auto kernel_of() {
  if constexpr (kFwd) {
    static_assert(!kResident, "K6a has the streamed route alone");
    return bn_fwd_kernel<T, VEC>;
  } else {
    return bn_bwd_kernel<T, VEC, kResident>;
  }
}

// Raise a kernel's dynamic shared memory limit to `smem`, once for each
// device and size (the limit belongs to the function on a device).
template <bool kFwd, typename T, int VEC, bool kResident>
cudaError_t allow_smem(int smem) {
  static int allowed[64];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    const cudaError_t f = cudaFuncSetAttribute(
        kernel_of<kFwd, T, VEC, kResident>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (f != cudaSuccess) return f;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

// A launch as ops/batch_norm.py launch_plan makes it: the route, the
// grid of co-resident blocks, the dynamic shared memory, the splits a
// resident block and the rounds a streamed block keeps.  tiles and rps
// follow from the geometry.
struct Plan {
  bool resident;
  int grid, smem, spb, keep, tiles, rps;
};

Plan make_plan(const Geometry& g, int vec, int resident, int grid, int smem,
               int spb, int keep) {
  const int rpi = kThreads / g.tpr;
  return Plan{resident != 0, grid, smem, spb, keep,
              (g.c + g.tpr * vec - 1) / (g.tpr * vec),
              (g.rows + rpi - 1) / rpi};
}

// whether the plan covers the geometry and its slab, of `round_bytes` a
// round, fits its shared memory
bool valid_plan(const Plan& p, const Geometry& g, int vec, int round_bytes) {
  if (p.grid < 1 || p.spb < 1 || p.keep < 0) return false;
  const int64_t items = static_cast<int64_t>(g.splits) * p.tiles;
  const int64_t slab = static_cast<int64_t>(p.keep) * round_bytes;
  if (p.resident)  // one block a group of spb splits, its slab all kept
    return vec > 1 && p.keep == p.spb * p.rps &&
           p.grid == (g.splits + p.spb - 1) / p.spb * p.tiles &&
           p.smem >= slab;
  // a streamed block keeps rounds only where it has one item
  return p.spb == 1 && p.smem >= 0 &&
         (p.keep == 0 || (vec > 1 && p.grid >= items && p.smem >= slab));
}

// one cooperative launch of the route's kernel
template <bool kFwd, typename T, int VEC, bool kResident, typename... Args>
int coop_launch(const Plan& p, cudaStream_t st, Args... args) {
  const cudaError_t e = allow_smem<kFwd, T, VEC, kResident>(p.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel_of<kFwd, T, VEC, kResident>(),
                            args...);
}

template <typename T, int VEC>
int fwd_launch(const Plan& p, const void* x, const void* gamma,
               const void* beta, float* rmean, float* rvar, void* y,
               void* mean_out, void* var_out, float* stats, float* ws,
               const Geometry& g, const FwdArgs& a, cudaStream_t st) {
  return coop_launch<true, T, VEC, false>(
      p, st, static_cast<const T*>(x), gamma, beta, rmean, rvar,
      static_cast<T*>(y), static_cast<T*>(mean_out), static_cast<T*>(var_out),
      stats, ws, g, a, p.tiles, p.keep);
}

template <typename T, int VEC, bool kResident>
int bwd_launch(const Plan& p, const void* x, const void* dy,
               const float* stats, const void* gamma, void* dx, void* dgamma,
               void* dbeta, float* ws, const Geometry& g, const BwdArgs& a,
               cudaStream_t st) {
  return coop_launch<false, T, VEC, kResident>(
      p, st, static_cast<const T*>(x), static_cast<const T*>(dy), stats,
      gamma, static_cast<T*>(dx), dgamma, dbeta, ws, g, a, p.tiles, p.spb,
      p.rps, p.keep);
}

// The access's instance of a launch of dtype T: 16 bytes (kVec) or
// scalar; K6b's resident route takes the 16-byte access only (cp.async
// copies 16 bytes; valid_plan refuses a scalar resident plan).
template <typename T>
int fwd_dispatch(const Plan& p, int vec, const void* x, const void* gamma,
                 const void* beta, float* rmean, float* rvar, void* y,
                 void* mean_out, void* var_out, float* stats, float* ws,
                 const Geometry& g, const FwdArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return fwd_launch<T, kVec>(p, x, gamma, beta, rmean, rvar, y, mean_out,
                               var_out, stats, ws, g, a, st);
  if (vec == 1)
    return fwd_launch<T, 1>(p, x, gamma, beta, rmean, rvar, y, mean_out,
                            var_out, stats, ws, g, a, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int bwd_dispatch(const Plan& p, int vec, const void* x, const void* dy,
                 const float* stats, const void* gamma, void* dx,
                 void* dgamma, void* dbeta, float* ws, const Geometry& g,
                 const BwdArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec && p.resident)
    return bwd_launch<T, kVec, true>(p, x, dy, stats, gamma, dx, dgamma,
                                     dbeta, ws, g, a, st);
  if (vec == kVec)
    return bwd_launch<T, kVec, false>(p, x, dy, stats, gamma, dx, dgamma,
                                      dbeta, ws, g, a, st);
  if (vec == 1 && !p.resident)
    return bwd_launch<T, 1, false>(p, x, dy, stats, gamma, dx, dgamma, dbeta,
                                   ws, g, a, st);
  return cudaErrorInvalidValue;
}

// the blocks an SM that the occupancy API allows a route's kernel with
// `smem` bytes of dynamic shared memory
template <bool kFwd, typename T, int VEC, bool kResident>
int occupancy_of(int smem, int* blocks) {
  const cudaError_t e = allow_smem<kFwd, T, VEC, kResident>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of<kFwd, T, VEC, kResident>(), kThreads, smem);
}

template <bool kFwd, typename T>
int occupancy_typed(int vec, int resident, int smem, int* blocks) {
  constexpr int kVec = 16 / sizeof(T);
  if (resident) {  // K6b's, of the 16-byte access
    if constexpr (!kFwd)
      if (vec == kVec) return occupancy_of<false, T, kVec, true>(smem, blocks);
    return cudaErrorInvalidValue;
  }
  if (vec == kVec) return occupancy_of<kFwd, T, kVec, false>(smem, blocks);
  if (vec == 1) return occupancy_of<kFwd, T, 1, false>(smem, blocks);
  return cudaErrorInvalidValue;
}

template <bool kFwd>
int occupancy(int dtype, int vec, int resident, int smem, int* blocks) {
  if (dtype == 0) return occupancy_typed<kFwd, float>(vec, resident, smem,
                                                      blocks);
  if (dtype == 1)
    return occupancy_typed<kFwd, __nv_bfloat16>(vec, resident, smem, blocks);
  if (dtype == 2)
    return occupancy_typed<kFwd, __half>(vec, resident, smem, blocks);
  return cudaErrorInvalidValue;
}

bool valid_code(int code) { return code >= 0 && code <= 2; }

}  // namespace

// K6a.  x and y (M, C) of dtype code `dtype`; gamma and beta (C,) of
// their own codes; rmean and rvar (C,) float32, read in predict mode
// (mode 2) and updated in place in mode 1; mean_out and var_out (C,) of
// x's type, written in train mode; stats (4, C) float32, written for the
// backward; ws holds 2 * C * splits floats of partial sums (train mode).
// One cooperative launch of the plan that ops/batch_norm.py launch_plan
// makes: grid, dynamic shared memory, rounds kept.
extern "C" int mxt_bn_fwd(const void* x, const void* gamma, const void* beta,
                          float* rmean, float* rvar, void* y, void* mean_out,
                          void* var_out, float* stats, float* ws, int m, int c,
                          int vec, int tpr, int splits, int rows, int dtype,
                          int gamma_code, int beta_code, int mode,
                          int fix_gamma, float eps, float momentum,
                          float one_minus_m, int grid, int smem, int keep,
                          void* stream) {
  const Geometry g{m, c, tpr, splits, rows};
  if (!valid(g, vec) || mode < 0 || mode > 2 || !valid_code(gamma_code) ||
      !valid_code(beta_code))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(g, vec, 0, grid, smem, 1, keep);
  if (!valid_plan(p, g, vec, kFwdRoundBytes)) return cudaErrorInvalidValue;
  const FwdArgs a{m,         c,          splits,    mode,     fix_gamma,
                  gamma_code, beta_code, eps,       momentum, one_minus_m};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_dispatch<float>(p, vec, x, gamma, beta, rmean, rvar, y,
                               mean_out, var_out, stats, ws, g, a, st);
  if (dtype == 1)
    return fwd_dispatch<__nv_bfloat16>(p, vec, x, gamma, beta, rmean, rvar, y,
                                       mean_out, var_out, stats, ws, g, a, st);
  if (dtype == 2)
    return fwd_dispatch<__half>(p, vec, x, gamma, beta, rmean, rvar, y,
                                mean_out, var_out, stats, ws, g, a, st);
  return cudaErrorInvalidValue;
}

// K6b.  x, dy and dx (M, C) of dtype code `dtype`; stats (4, C) from
// K6a; gamma (C,) of gamma_code; dgamma and dbeta (C,) of the codes of
// gamma and beta, or null where no gradient is wanted; ws holds
// 2 * C * splits + 3 * C floats.  One cooperative launch of the plan that
// ops/batch_norm.py launch_plan makes: route (1 resident, 0 streamed),
// grid, dynamic shared memory, splits a resident block, rounds kept.
extern "C" int mxt_bn_bwd(const void* x, const void* dy, const float* stats,
                          const void* gamma, void* dx, void* dgamma,
                          void* dbeta, float* ws, int m, int c, int vec,
                          int tpr, int splits, int rows, int dtype,
                          int gamma_code, int beta_code, int train,
                          int fix_gamma, int resident, int grid, int smem,
                          int spb, int keep, void* stream) {
  const Geometry g{m, c, tpr, splits, rows};
  if (!valid(g, vec) || !valid_code(gamma_code) || !valid_code(beta_code))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(g, vec, resident, grid, smem, spb, keep);
  if (!valid_plan(p, g, vec, kBwdRoundBytes)) return cudaErrorInvalidValue;
  const BwdArgs a{m, c, splits, train, fix_gamma, gamma_code, beta_code};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dispatch<float>(p, vec, x, dy, stats, gamma, dx, dgamma, dbeta,
                               ws, g, a, st);
  if (dtype == 1)
    return bwd_dispatch<__nv_bfloat16>(p, vec, x, dy, stats, gamma, dx,
                                       dgamma, dbeta, ws, g, a, st);
  if (dtype == 2)
    return bwd_dispatch<__half>(p, vec, x, dy, stats, gamma, dx, dgamma,
                                dbeta, ws, g, a, st);
  return cudaErrorInvalidValue;
}

// The blocks an SM that the occupancy API allows K6a's kernel of dtype
// code `dtype`, `vec` channels an access and `smem` bytes of dynamic
// shared memory (K6b's: of the route, 1 resident, 0 streamed), into
// *blocks, on the current device.
extern "C" int mxt_bn_fwd_occupancy(int dtype, int vec, int smem,
                                    int* blocks) {
  return occupancy<true>(dtype, vec, 0, smem, blocks);
}

extern "C" int mxt_bn_bwd_occupancy(int dtype, int vec, int resident,
                                    int smem, int* blocks) {
  return occupancy<false>(dtype, vec, resident, smem, blocks);
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
