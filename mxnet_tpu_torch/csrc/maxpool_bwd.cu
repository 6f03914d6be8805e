// Max-pooling backward (dX) for Hopper (sm_90a), CUDA C++.
//
// Replaces mxnet_tpu/ops/pallas_pool.py::_bwd_kernel (K2), the Pallas TPU
// kernel behind maxpool_bwd_nhwc.  It computes the same function for an
// NHWC input: each pooling window's dy goes to the window's FIRST argmax,
// found by the JAX kernel's comparison sequence (tap 0 first, then v > m
// strictly, taps in row-major order), with taps in the padding reading
// -inf.  When a window's first argmax is a padded tap (all of its real
// taps are -inf, or NaN rules say so), the JAX kernel routes dy into the
// pad region, which its wrapper slices away: here that dy is dropped,
// never given to a real pixel.  Padding is given on the low side; the high
// side is whatever the output size needs (the 'full' convention), read as
// -inf as well.
//
// Design: two passes, no atomics, so dX repeats bit for bit.
//   1. argmax: one thread per output element (n, oy, ox, c), c fastest,
//      writes the index of its window's first argmax tap as one byte
//      (windows of at most 255 taps);
//   2. gather: one thread per input element (n, h, w, c), c fastest, loops
//      over the windows that cover it in window order (oy, then ox,
//      ascending), adds in float32 the dy of every window whose argmax is
//      this pixel's tap, and rounds the sum once to dy's type.
// The Pallas kernel instead scatters dy through kh*kw strided
// read-modify-writes of a VMEM-resident block, accumulating in dy's type.
//
// Bound on the H100: bytes.  At ResNet-50's 3x3/s2/p1 pool on
// (128, 112, 112, 64) bf16, x, dy and dx are 462 MB together, 0.14 ms at
// 3.35 TB/s; the work is comparisons and adds, far below any peak.  The
// argmax pass reads each input about 2.25 times (overlapping windows) and
// the gather reads each dy and index byte about 2.25 times; those re-reads
// hit L1/L2, so device memory sees x, dy and dx about once, plus the index
// bytes (26 MB) twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Shape {
  int n, h, w, c;      // x and dx
  int oh, ow;          // dy
  int kh, kw, sy, sx, py, px;
};

// Both kernels walk rows (n, y) over gridDim.y and a row's (x, c) over
// the threads of gridDim.x blocks, so the index arithmetic is 32-bit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_argmax_kernel(const T* __restrict__ x, uint8_t* __restrict__ idx,
                      Shape s) {
  const int row_len = s.ow * s.c;
  for (int row = blockIdx.y; row < s.n * s.oh; row += gridDim.y) {
    const int n = row / s.oh;
    const int y0 = (row - n * s.oh) * s.sy - s.py;
    const T* xn = x + (int64_t)n * s.h * s.w * s.c;
    uint8_t* out = idx + (int64_t)row * row_len;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < row_len;
         j += gridDim.x * blockDim.x) {
      const int ox = j / s.c;
      const int c = j - ox * s.c;
      const int x0 = ox * s.sx - s.px;
      float m = 0.f;
      int best = 0;
      for (int r = 0; r < s.kh; ++r) {
        const int yy = y0 + r;
        for (int q = 0; q < s.kw; ++q) {
          const int xx = x0 + q;
          float v = -INFINITY;
          if (yy >= 0 && yy < s.h && xx >= 0 && xx < s.w)
            v = to_f32(xn[((int64_t)yy * s.w + xx) * s.c + c]);
          const int tap = r * s.kw + q;
          if (tap == 0) {
            m = v;
          } else if (v > m) {  // strict: ties keep the earlier tap
            m = v;
            best = tap;
          }
        }
      }
      out[j] = (uint8_t)best;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_gather_kernel(const T* __restrict__ dy,
                      const uint8_t* __restrict__ idx, T* __restrict__ dx,
                      Shape s) {
  const int row_len = s.w * s.c;
  for (int row = blockIdx.y; row < s.n * s.h; row += gridDim.y) {
    const int n = row / s.h;
    // windows oy with oy*sy - py <= h < oy*sy - py + kh, likewise ox
    const int hy = row - n * s.h + s.py;
    const int oy_lo = hy - s.kh + 1 <= 0 ? 0 : (hy - s.kh + s.sy) / s.sy;
    const int oy_hi = min(hy / s.sy, s.oh - 1);
    const int64_t dyn = (int64_t)n * s.oh * s.ow * s.c;
    T* out = dx + (int64_t)row * row_len;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < row_len;
         j += gridDim.x * blockDim.x) {
      const int wx = j / s.c;
      const int c = j - wx * s.c;
      const int xw = wx + s.px;
      const int ox_lo = xw - s.kw + 1 <= 0 ? 0 : (xw - s.kw + s.sx) / s.sx;
      const int ox_hi = min(xw / s.sx, s.ow - 1);
      float sum = 0.f;
      for (int oy = oy_lo; oy <= oy_hi; ++oy) {
        const int r = hy - oy * s.sy;
        for (int ox = ox_lo; ox <= ox_hi; ++ox) {
          const int tap = r * s.kw + (xw - ox * s.sx);
          const int64_t o = dyn + ((int64_t)oy * s.ow + ox) * s.c + c;
          if (idx[o] == tap) sum += to_f32(dy[o]);
        }
      }
      store(out + j, sum);
    }
  }
}

dim3 grid_for(int rows, int row_len) {
  const int bx = (row_len + kThreads - 1) / kThreads;
  return dim3(bx < 1024 ? bx : 1024, rows < 65535 ? rows : 65535);
}

template <typename T>
int launch(const void* x, const void* dy, void* idx, void* dx, const Shape& s,
           cudaStream_t stream) {
  maxpool_argmax_kernel<T>
      <<<grid_for(s.n * s.oh, s.ow * s.c), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<uint8_t*>(idx), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  maxpool_gather_kernel<T>
      <<<grid_for(s.n * s.h, s.w * s.c), kThreads, 0, stream>>>(
          static_cast<const T*>(dy), static_cast<const uint8_t*>(idx),
          static_cast<T*>(dx), s);
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, C), dy (N, OH, OW, C) contiguous of one dtype (0 float32,
// 1 bf16); idx (N, OH, OW, C) uint8 scratch; dx (N, H, W, C) in that dtype.
extern "C" int mxt_maxpool_bwd(const void* x, const void* dy, void* idx,
                               void* dx, int n, int h, int w, int c, int oh,
                               int ow, int kh, int kw, int sy, int sx, int py,
                               int px, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0 || kh <= 0 ||
      kw <= 0 || kh * kw > 255 || sy <= 0 || sx <= 0 || py < 0 || px < 0 ||
      (int64_t)n * h > INT32_MAX || (int64_t)w * c > INT32_MAX ||
      (int64_t)n * oh > INT32_MAX || (int64_t)ow * c > INT32_MAX)
    return cudaErrorInvalidValue;
  Shape s{n, h, w, c, oh, ow, kh, kw, sy, sx, py, px};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dy, idx, dx, s, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, idx, dx, s, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
