// Convolution backward-filter (dW) for Hopper (sm_90a), CUDA C++ on the
// CUDA cores.
//
// Replaces mxnet_tpu/ops/pallas_conv.py::_dw_kernel_pertap (K1a) and
// ::_dw_kernel_im2col (K1b), the Pallas TPU kernels behind conv_dw_nhwc.
// It computes the same function for an NHWC input and OHWI weights
// (groups 1, dilation 1):
//   dW[o, r, s, i] = sum_{n,y,x} X[n, y*sy + r - py, x*sx + s - px, i]
//                                * dY[n, y, x, o]
// with taps outside the image reading as 0, so nothing is padded in device
// memory (the JAX wrapper pads x with jnp.pad).  Inputs are float32 or
// bf16, the sum runs in float32 and dW is written in float32; the caller
// casts it to the weight's type.
//
// Design.  dW^T is an implicit GEMM, C[m, o] = sum_p A[p, m] * B[p, o],
// over the reduction axis p = (n, y, x), K = N*OH*OW (1.6 M at the ResNet
// stem, 6,272 at stage 4); B is dY read row by row, A is gathered from X.
// The two formulations differ in what a block's 64 rows m are:
//   - per-tap (K1a, the rule for I >= 128): one tap (r, s), 64 input
//     channels i of it; blockIdx.z carries the tap;
//   - im2col (K1b, I < 128): 64 consecutive rows of the flattened (r, s, i)
//     axis, so a narrow layer (I=3 at the stem: 147 rows; I=64 at 3x3: 576
//     rows) fills whole tiles.
// A block computes a 64 x 64 (m, o) tile with 256 threads, 4 x 4 outputs
// each, over stages of 16 reduction positions held in shared memory as
// float32 (bf16 is widened on the way in), double-buffered through
// registers.  Every thread loads one column (m or o) of 4 consecutive
// positions p, so a warp reads 32 consecutive channels; the position's
// (n, y, x) is advanced incrementally, never divided out per load.
//
// The Pallas kernels carry the accumulator across a sequential image
// grid.  Hopper blocks run in no order, and the stem has 64 x 147 outputs
// over a 1.6 M-term sum, so the reduction is split: split-K with a fixed
// partition.  Block (tile, split) sums its chunk of p in order and writes
// a float32 partial to a workspace laid out as [split][o][m]; a second
// kernel sums the partials of each output in split order and writes dW.
// No atomics, so dW repeats bit for bit.  The split count comes from the
// caller (ops/conv_dw.py split_plan), chosen so that every conv of
// ResNet-50 puts at least 4 x 132 blocks in flight.  Ragged edges (I=3,
// O not a multiple of 64, 7x7 taps at the border, a partial last chunk)
// are masked in the kernel.
//
// Bound on the H100.  dW of ResNet-50 is about 4 GMAC per image, about
// 1 TFLOP a step at batch 128.  These kernels run float32 FMAs on the CUDA
// cores (67 TFLOP/s), not the tensor cores (989 TFLOP/s bf16), so they are
// bound by operations; the bytes (x and dy once, 0.1-0.4 GB a conv) are
// far below.  Reading both operands of every FMA from shared memory (2
// vector loads per 16 FMAs) holds this first version to a fraction of the
// CUDA-core peak; tensor cores (mma/wgmma on bf16) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows m of a tile
constexpr int kBN = 64;        // output channels o of a tile
constexpr int kBK = 16;        // reduction positions p per stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRowsPerThread = kBK * kBM / kThreads;  // 4 positions

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Shape {
  int n, h, w, ci;        // x
  int oh, ow, co;         // dy
  int kh, kw, sy, sx, py, px;
  int mt;                 // rows of dW^T: kh * kw * ci
  int splits, chunk;      // split-K: chunk positions per split
};

// A running reduction position: p and its (n, y, x).
struct Pos {
  int p, n, y, x;
  __device__ __forceinline__ void advance(int by, const Shape& s) {
    p += by;
    x += by;
    while (x >= s.ow) {
      x -= s.ow;
      if (++y == s.oh) {
        y = 0;
        ++n;
      }
    }
  }
};

template <bool kIm2col, typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               float* __restrict__ ws, Shape s) {
  __shared__ __align__(16) float sA[2][kBK][kBM];
  __shared__ __align__(16) float sB[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int col = tid % kBM;                      // this thread's load column
  const int row0 = (tid / kBM) * kRowsPerThread;  // its first load row
  const int tx = tid % 16, ty = tid / 16;         // its 4 x 4 outputs

  int split, m_base;  // m_base: first row of the tile on the flattened axis
  int tap_r = 0, tap_s = 0;
  if (kIm2col) {
    split = blockIdx.z;
    m_base = blockIdx.x * kBM;
  } else {
    const int tap = blockIdx.z / s.splits;
    split = blockIdx.z % s.splits;
    tap_r = tap / s.kw;
    tap_s = tap % s.kw;
    m_base = tap * s.ci + blockIdx.x * kBM;
  }
  const int o0 = blockIdx.y * kBN;
  const int k_total = s.n * s.oh * s.ow;
  const int p_begin = split * s.chunk;
  const int p_end = min(p_begin + s.chunk, k_total);

  // the A column this thread loads: tap offsets and channel, fixed for
  // the whole reduction
  int a_dy, a_dx, a_i;
  bool a_ok;
  if (kIm2col) {
    const int m = m_base + col;
    a_ok = m < s.mt;
    const int mm = a_ok ? m : 0;
    a_i = mm % s.ci;
    const int tap = mm / s.ci;
    a_dy = tap / s.kw - s.py;
    a_dx = tap % s.kw - s.px;
  } else {
    a_i = blockIdx.x * kBM + col;
    a_ok = a_i < s.ci;
    a_dy = tap_r - s.py;
    a_dx = tap_s - s.px;
  }
  const int b_o = o0 + col;
  const bool b_ok = b_o < s.co;

  Pos pos;
  pos.p = p_begin;
  pos.n = p_begin / (s.oh * s.ow);
  const int rem = p_begin % (s.oh * s.ow);
  pos.y = rem / s.ow;
  pos.x = rem % s.ow;
  pos.advance(row0, s);

  float ra[kRowsPerThread], rb[kRowsPerThread];
  auto load = [&](Pos q) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      float a = 0.f, b = 0.f;
      if (q.p < p_end) {
        if (a_ok) {
          const int yy = q.y * s.sy + a_dy;
          const int xx = q.x * s.sx + a_dx;
          if (yy >= 0 && yy < s.h && xx >= 0 && xx < s.w)
            a = to_f32(x[((int64_t)(q.n * s.h + yy) * s.w + xx) * s.ci + a_i]);
        }
        if (b_ok) b = to_f32(dy[(int64_t)q.p * s.co + b_o]);
      }
      ra[j] = a;
      rb[j] = b;
      q.advance(1, s);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      sA[buf][row0 + j][col] = ra[j];
      sB[buf][row0 + j][col] = rb[j];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int stages = (p_end - p_begin + kBK - 1) / kBK;
  load(pos);
  store(0);
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < stages) {
      pos.advance(kBK, s);
      load(pos);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[buf][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[buf][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (st + 1 < stages) store(buf ^ 1);
    __syncthreads();
  }

  // the partial of this split, OHWI order: ws[split][o][m]
  float* out = ws + (int64_t)split * s.co * s.mt;
  const int m_end = kIm2col ? s.mt : (m_base - blockIdx.x * kBM) + s.ci;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + tx * 4 + j;
    if (o >= s.co) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m_base + ty * 4 + i;
      if (m < m_end) out[(int64_t)o * s.mt + m] = acc[i][j];
    }
  }
}

// dW[e] = sum over splits, in split order, of ws[split][e]
__global__ void conv_dw_reduce_kernel(const float* __restrict__ ws,
                                      float* __restrict__ dw, int64_t elems,
                                      int splits) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < elems;
       e += (int64_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) sum += ws[sp * elems + e];
    dw[e] = sum;
  }
}

template <bool kIm2col, typename T>
int launch(const void* x, const void* dy, float* ws, float* dw, const Shape& s,
           cudaStream_t stream) {
  const int m_rows = kIm2col ? s.mt : s.ci;
  const int64_t gz = kIm2col ? (int64_t)s.splits
                             : (int64_t)s.kh * s.kw * s.splits;
  if (gz > 65535 || (s.co + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 grid((m_rows + kBM - 1) / kBM, (s.co + kBN - 1) / kBN, (unsigned)gz);
  conv_dw_kernel<kIm2col, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t elems = (int64_t)s.co * s.mt;
  const int64_t blocks = (elems + 255) / 256;
  conv_dw_reduce_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                          stream>>>(ws, dw, elems, s.splits);
  return cudaGetLastError();
}

template <bool kIm2col>
int dispatch(const void* x, const void* dy, void* ws, void* dw, int n, int h,
             int w, int ci, int oh, int ow, int co, int kh, int kw, int sy,
             int sx, int py, int px, int splits, int chunk, int dtype,
             void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || ci <= 0 || oh <= 0 || ow <= 0 || co <= 0 ||
      kh <= 0 || kw <= 0 || sy <= 0 || sx <= 0 || splits <= 0 || chunk <= 0 ||
      (int64_t)splits * chunk < (int64_t)n * oh * ow)
    return cudaErrorInvalidValue;
  Shape s{n, h, w, ci, oh, ow, co, kh, kw, sy, sx, py, px, kh * kw * ci,
          splits, chunk};
  auto st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 0) return launch<kIm2col, float>(x, dy, wsf, dwf, s, st);
  if (dtype == 1) return launch<kIm2col, __nv_bfloat16>(x, dy, wsf, dwf, s, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (N, H, W, I) and dy (N, OH, OW, O) contiguous, of one dtype (0 float32,
// 1 bf16); ws float32 [splits][O][KH*KW*I]; dw float32 (O, KH, KW, I).
extern "C" int mxt_conv_dw_pertap(const void* x, const void* dy, void* ws,
                                  void* dw, int n, int h, int w, int ci,
                                  int oh, int ow, int co, int kh, int kw,
                                  int sy, int sx, int py, int px, int splits,
                                  int chunk, int dtype, void* stream) {
  return dispatch<false>(x, dy, ws, dw, n, h, w, ci, oh, ow, co, kh, kw, sy,
                         sx, py, px, splits, chunk, dtype, stream);
}

extern "C" int mxt_conv_dw_im2col(const void* x, const void* dy, void* ws,
                                  void* dw, int n, int h, int w, int ci,
                                  int oh, int ow, int co, int kh, int kw,
                                  int sy, int sx, int py, int px, int splits,
                                  int chunk, int dtype, void* stream) {
  return dispatch<true>(x, dy, ws, dw, n, h, w, ci, oh, ow, co, kh, kw, sy,
                        sx, py, px, splits, chunk, dtype, stream);
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
