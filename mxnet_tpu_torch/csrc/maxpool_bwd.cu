// Max-pooling backward (dX) for Hopper (sm_90a), CUDA C++: one fused pass.
//
// Replaces mxnet_tpu/ops/pallas_pool.py::_bwd_kernel (K2), the Pallas TPU
// kernel behind maxpool_bwd_nhwc.  It computes the same function for an
// NHWC input: each pooling window's dy goes to the window's FIRST argmax,
// found by the JAX kernel's comparison sequence (tap 0 first, then v > m
// strictly, taps in row-major order), with taps in the padding reading
// -inf; a NaN at tap 0 keeps tap 0, a NaN at a later tap is never taken.
// When a window's first argmax is a padded tap (all of its real taps are
// -inf, or the window lies wholly in the padding), the JAX kernel routes
// dy into the pad region, which its wrapper slices away: here that dy is
// dropped, never given to a real pixel.  Padding is given on the low side;
// the high side is whatever dy's size needs, read as -inf as well.  Each
// pixel adds the dy it receives in float32 in window order (oy, then ox,
// ascending) and rounds once to dy's type, so dX equals the plain version
// (ops/pool_bwd.py maxpool_bwd_reference) bit for bit.  (The JAX kernel
// accumulates in dy's type.)
//
// Design: one launch, no scratch in device memory, no atomics.
//   - Ownership.  A block owns one tile of dX: tile_h rows x tile_w
//     columns x tile_c channels of one image, and writes each of its
//     elements once (zeros where no window's argmax lands).
//   - Staging.  It copies into shared memory the x halo that the windows
//     covering its tile read, and those windows' dy: 16-byte cp.async
//     copies along C (8 channels of bf16 or float16, 4 of float32), or
//     scalar loads where C or a pointer's alignment does not allow them
//     (the wrapper picks the path from the shapes and the pointers).
//     Halo positions in the padding are not loaded; they read as -inf.
//   - Argmax.  Each thread takes (window, access) pairs: it compares the
//     window's taps over the access's channels in registers and keeps each
//     channel's argmax tap in shared memory, as the 16 bits of the tap
//     index's float16 value (exact below 2048).  Two-byte types compare
//     two channels an instruction (__hgt2_mask: ordered, so NaN never
//     wins) and select with bit masks.  A tile's neighbours compute the
//     windows of the shared halo again (one window row and column at
//     3x3/s2); nothing is exchanged between blocks.
//   - Gather.  Each thread keeps a column and access of the tile and
//     walks its rows, so the windows along x are worked out once; the
//     columns are dealt out in order of their class modulo the stride, so
//     the pixels of a warp cover as many windows each and no lane idles
//     through another's window.  A pixel adds, in float32 in window order,
//     the dy of the windows whose argmax is its tap; two-byte types compare
//     two taps an instruction (__heq2_mask) and mask the dy bits of the
//     others to +0, which adds nothing (a sum that starts at +0 is never
//     -0).  One 16-byte (or scalar) store writes the rounded sums.
//   - Index arithmetic divides only by the launch's constants, by a
//     multiply and a shift (FastDiv).
// The tile sizes come from the caller (ops/pool_bwd.py launch_plan, which
// halves the tile until its staging fits 72 KB, so any window of up to 255
// taps and any stride runs); this file computes the same bounds.  The
// Pallas kernel instead scatters dy through kh*kw strided
// read-modify-writes of a VMEM-resident block of the whole image.
//
// Bound on the H100: bytes.  At ResNet-50's 3x3/s2/p1 pool on
// (128, 112, 112, 64) bf16, x, dy and dx are 462 MB together, 0.138 ms at
// 3.35 TB/s; the work is comparisons and adds, far below any peak, yet
// the kernel issues instructions for longer than it moves bytes
// (pool_bwd_probe.py; PERF.md).  A 16 x 16 tile there stages a 19 x 19
// halo of x (1.41 times the tile; the overlap with its neighbours is read
// from L2), 9 x 9 windows of dy and their argmax in 65 KB, so three blocks
// share an SM.  Double-buffering the staging for the next tile (a
// persistent grid) was no faster in trials on an H100: the second buffer
// halves the tile.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

struct Shape {
  int n, h, w, c;      // x and dx
  int oh, ow;          // dy
  int kh, kw, sy, sx, py, px;
};

// n / d for 0 <= n < 2^31 by a multiply and a shift, with m and s found
// once on the host (the round-up method of Granlund and Montgomery, as in
// PyTorch's IntDivider): a hardware division takes about 20 instructions
struct FastDiv {
  uint32_t m, s;
};

FastDiv fast_div(uint32_t d) {  // 1 <= d < 2^31
  uint32_t s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t m =
      ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1;
  return {static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return static_cast<int>(
      (__umulhi(static_cast<uint32_t>(n), f.m) + static_cast<uint32_t>(n)) >>
      f.s);
}

// ops/pool_bwd.py LaunchPlan: the tile, how many tiles cover H, W and C,
// the most windows over a tile and x pixels they read (the pitches of the
// staged arrays), and where dy and the argmax array start in shared
// memory; with the divisors of the index arithmetic and the gather's
// lanes (below)
struct Plan {
  int th, tw, tc, cu;          // cu: accesses a pixel's tc channels take
  int tiles_h, tiles_w, chunks, tiles;
  int wy, wx, hh, hw;
  int dy_off, arg_off, smem;
  int lanes, rows_a_pass, classes;
  FastDiv by_cu, by_hw, by_wx, by_sy, by_sx, by_lanes, by_classes;
};

int align16(int64_t b) { return (int)((b + 15) / 16 * 16); }
int imin(int a, int b) { return a < b ? a : b; }

// the same sums as ops/pool_bwd.py _staging
Plan make_plan(const Shape& s, int th, int tw, int tc, int vec, int esize) {
  Plan p;
  p.th = th;
  p.tw = tw;
  p.tc = tc;
  p.cu = tc / vec;
  p.tiles_h = (s.h + th - 1) / th;
  p.tiles_w = (s.w + tw - 1) / tw;
  p.chunks = (s.c + tc - 1) / tc;
  const int64_t tiles = (int64_t)s.n * p.tiles_h * p.tiles_w * p.chunks;
  p.tiles = tiles > INT32_MAX ? -1 : (int)tiles;
  p.wy = imin((th + s.kh - 2) / s.sy + 1, s.oh);
  p.wx = imin((tw + s.kw - 2) / s.sx + 1, s.ow);
  p.hh = (p.wy - 1) * s.sy + s.kh;
  p.hw = (p.wx - 1) * s.sx + s.kw;
  const int64_t win = (int64_t)p.wy * p.wx * tc;
  p.dy_off = align16((int64_t)p.hh * p.hw * tc * esize);
  p.arg_off = p.dy_off + align16(win * esize);
  p.smem = align16(p.arg_off + 2 * win);
  // the gather's lanes, (column, access) pairs: a thread keeps one (or,
  // past kThreads lanes, several) and walks rows_a_pass rows apart; the
  // columns go by class modulo the stride when the stride divides tw
  p.lanes = tw * p.cu;
  p.rows_a_pass = p.lanes < kThreads ? kThreads / p.lanes : 1;
  p.classes = s.sx > 1 && tw % s.sx == 0 ? tw / s.sx : 0;
  p.by_cu = fast_div(p.cu);
  p.by_hw = fast_div(p.hw);
  p.by_wx = fast_div(p.wx);
  p.by_sy = fast_div(s.sy);
  p.by_sx = fast_div(s.sx);
  p.by_lanes = fast_div(p.lanes);
  p.by_classes = fast_div(p.classes > 0 ? p.classes : 1);
  return p;
}

// the first window along one axis that covers padded position y
__device__ __forceinline__ int first_window(int y, int k, int s,
                                            const FastDiv& by_s) {
  return y - k + 1 <= 0 ? 0 : (y - k + s) / by_s;
}

// a tap's index as the 16 bits of its float16 value, the form in which
// the argmax array keeps it
__device__ __forceinline__ uint16_t tap16(int t) {
  return __half_as_ushort(__int2half_rn(t));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __half from_f32(float x, __half*) { return __float2half_rn(x); }

// two-byte types, two channels a 32-bit word: 0xffff in each half where a
// > b (ordered: false for NaN), the low and high channel as float32, and
// -inf in both halves
__device__ __forceinline__ uint32_t gt_mask(uint32_t a, uint32_t b, __nv_bfloat16*) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  return __hgt2_mask(x, y);
}
__device__ __forceinline__ uint32_t gt_mask(uint32_t a, uint32_t b, __half*) {
  __half2 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  return __hgt2_mask(x, y);
}
__device__ __forceinline__ float lo_f32(uint32_t w, __nv_bfloat16*) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w, __nv_bfloat16*) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float lo_f32(uint32_t w, __half*) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float hi_f32(uint32_t w, __half*) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
__host__ __device__ constexpr uint32_t neg_inf2(__nv_bfloat16*) { return 0xff80ff80u; }
__host__ __device__ constexpr uint32_t neg_inf2(__half*) { return 0xfc00fc00u; }

// the arg halves equal to tap (both float16 bit patterns): 0xffff each
__device__ __forceinline__ uint32_t eq_mask(uint32_t a, uint32_t tap2) {
  __half2 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &tap2, 4);
  return __heq2_mask(x, y);
}

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[V]) {
  T e[V];
  if constexpr (V > 1) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(e, &u, sizeof(u));
  } else {
    e[0] = *p;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_rounded(T* p, const float (&v)[V]) {
  T e[V];
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f32(v[j], (T*)nullptr);
  if constexpr (V > 1) {
    uint4 u;
    memcpy(&u, e, sizeof(u));
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = e[0];
  }
}

// global -> shared: one 16-byte cp.async, or one scalar load and store
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (V > 1) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// where a tile lies: its image, rows [h0, h1), columns [w0, w1), first
// channel c0 and accesses a pixel cu; the windows that cover it, rows
// [oy0, oy0 + wy) and columns [ox0, ox0 + wx) (none when wy or wx <= 0),
// and the halo of x they read from (y0, x0) in image coordinates, hh x hw
// (ops/pool_bwd.py tile_geometry: tiles, and so blocks, run channel chunk
// fastest, then tile column, tile row, image)
struct Tile {
  int n, h0, h1, w0, w1, c0, cu;
  int oy0, oy1, ox0, ox1, wy, wx, y0, x0, hh, hw;
};

template <int V>
__device__ __forceinline__ Tile locate(int t, const Shape& s, const Plan& p) {
  Tile g;
  const int chunk = t % p.chunks;
  t /= p.chunks;
  const int tcol = t % p.tiles_w;
  t /= p.tiles_w;
  const int trow = t % p.tiles_h;
  g.n = t / p.tiles_h;
  g.h0 = trow * p.th;
  g.h1 = min(g.h0 + p.th, s.h);
  g.w0 = tcol * p.tw;
  g.w1 = min(g.w0 + p.tw, s.w);
  g.c0 = chunk * p.tc;
  g.cu = min(p.tc, s.c - g.c0) / V;  // this chunk's (C % V == 0)
  g.oy0 = first_window(g.h0 + s.py, s.kh, s.sy, p.by_sy);
  g.oy1 = min((g.h1 - 1 + s.py) / p.by_sy, s.oh - 1);
  g.ox0 = first_window(g.w0 + s.px, s.kw, s.sx, p.by_sx);
  g.ox1 = min((g.w1 - 1 + s.px) / p.by_sx, s.ow - 1);
  g.wy = g.oy1 - g.oy0 + 1;
  g.wx = g.ox1 - g.ox0 + 1;
  g.y0 = g.oy0 * s.sy - s.py;
  g.x0 = g.ox0 * s.sx - s.px;
  g.hh = (g.wy - 1) * s.sy + s.kh;
  g.hw = (g.wx - 1) * s.sx + s.kw;
  return g;
}

// issue the copies of a tile's halo of x and its windows' dy (x
// [hh][hw][cu] from buf, dy [wy][wx][cu] from buf + dy_off, at the plan's
// pitches; a tile at the edge fills part of them)
template <typename T, int V>
__device__ __forceinline__ void stage_tile(const Tile& g, uint8_t* buf,
                                           const T* __restrict__ x,
                                           const T* __restrict__ dy,
                                           const Shape& s, const Plan& p) {
  if (g.wy <= 0 || g.wx <= 0) return;
  T* sx = reinterpret_cast<T*>(buf);
  T* sdy = reinterpret_cast<T*>(buf + p.dy_off);
  const int64_t img = (int64_t)g.n * s.h * s.w;
  for (int i = threadIdx.x; i < p.hh * p.hw * p.cu; i += kThreads) {
    const int pix = i / p.by_cu, u = i - pix * p.cu;
    const int r = pix / p.by_hw, q = pix - r * p.hw;
    const int y = g.y0 + r, xx = g.x0 + q;
    if (r < g.hh && q < g.hw && u < g.cu && (unsigned)y < (unsigned)s.h &&
        (unsigned)xx < (unsigned)s.w)
      stage<T, V>(sx + i * V,
                  x + (img + (int64_t)y * s.w + xx) * s.c + g.c0 + u * V);
  }
  for (int i = threadIdx.x; i < p.wy * p.wx * p.cu; i += kThreads) {
    const int win = i / p.by_cu, u = i - win * p.cu;
    const int a = win / p.by_wx, bb = win - a * p.wx;
    if (a < g.wy && bb < g.wx && u < g.cu)
      stage<T, V>(sdy + i * V,
                  dy + (((int64_t)g.n * s.oh + g.oy0 + a) * s.ow + g.ox0 + bb) *
                           s.c + g.c0 + u * V);
  }
}

// the first argmax tap of window (a, bb) over access u's channels
template <typename T, int V>
__device__ __forceinline__ void window_argmax(const Tile& g, const T* sx,
                                              uint16_t* arg, int a, int bb,
                                              int u, const Shape& s,
                                              const Plan& p) {
  constexpr bool kPacked = sizeof(T) == 2 && V == 8;
  uint32_t m2[4], best2[4];  // two-byte types: two channels a word
  float m[V];
  uint16_t best[V];
  int t = 0;
  for (int r = 0; r < s.kh; ++r) {
    const int hr = a * s.sy + r;
    const bool row_in = (unsigned)(g.y0 + hr) < (unsigned)s.h;
    const T* row = sx + ((hr * p.hw + bb * s.sx) * p.cu + u) * V;
    for (int q = 0; q < s.kw; ++q, ++t) {
      const bool in = row_in && (unsigned)(g.x0 + bb * s.sx + q) < (unsigned)s.w;
      if constexpr (kPacked) {
        uint4 w4 = make_uint4(neg_inf2((T*)nullptr), neg_inf2((T*)nullptr),
                              neg_inf2((T*)nullptr), neg_inf2((T*)nullptr));
        if (in) w4 = *reinterpret_cast<const uint4*>(row + q * p.cu * V);
        const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
        if (t == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            m2[k] = w[k];
            best2[k] = 0u;  // tap 0: float16 +0
          }
        } else {
          const uint32_t tap2 = tap16(t) * 0x00010001u;
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // strict: ties keep the earlier tap
            const uint32_t take = gt_mask(w[k], m2[k], (T*)nullptr);
            m2[k] = (w[k] & take) | (m2[k] & ~take);
            best2[k] = (tap2 & take) | (best2[k] & ~take);
          }
        }
      } else {
        float v[V];
        if (in) {
          load_f32<T, V>(row + q * p.cu * V, v);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = -INFINITY;  // padding
        }
        const uint16_t tap = tap16(t);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (t == 0 || v[j] > m[j]) {  // strict: ties keep the earlier tap
            m[j] = v[j];
            best[j] = tap;
          }
        }
      }
    }
  }
  if constexpr (kPacked) {
    *reinterpret_cast<uint4*>(arg) = make_uint4(best2[0], best2[1], best2[2], best2[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) arg[j] = best[j];
  }
}

// dX of one pixel over access u's channels: padded position (yp, xp), the
// windows [ya, yb] x [xa, xb] that cover it
template <typename T, int V>
__device__ __forceinline__ void pixel_grad(const Tile& g, const T* sdy,
                                           const uint16_t* sarg, int yp,
                                           int ya, int yb, int xp, int xa,
                                           int xb, int u, T* __restrict__ out,
                                           const Shape& s, const Plan& p) {
  constexpr bool kPacked = sizeof(T) == 2 && V == 8;
  float sum[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sum[j] = 0.f;
  for (int oy = ya; oy <= yb; ++oy) {
    const int row_tap = (yp - oy * s.sy) * s.kw;
    const int row_at = (oy - g.oy0) * p.wx;
    for (int ox = xa; ox <= xb; ++ox) {
      const int tap = row_tap + xp - ox * s.sx;
      const int at = ((row_at + ox - g.ox0) * p.cu + u) * V;
      if constexpr (kPacked) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(sarg + at);
        const uint4 d4 = *reinterpret_cast<const uint4*>(sdy + at);
        const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
        const uint32_t d[4] = {d4.x, d4.y, d4.z, d4.w};
        const uint32_t tap2 = tap16(tap) * 0x00010001u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // another window's argmax: its dy bits become +0, which adds 0
          const uint32_t mine = d[k] & eq_mask(a[k], tap2);
          sum[2 * k] += lo_f32(mine, (T*)nullptr);
          sum[2 * k + 1] += hi_f32(mine, (T*)nullptr);
        }
      } else {
        float dv[V];
        load_f32<T, V>(sdy + at, dv);
        const uint16_t t16 = tap16(tap);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (sarg[at + j] == t16) sum[j] += dv[j];
      }
    }
  }
  store_rounded<T, V>(out, sum);
}

// V: channels an access (16 / sizeof(T), or 1 on the scalar path); one
// block a tile
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, Shape s, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const T* sx = reinterpret_cast<const T*>(smem);
  const T* sdy = reinterpret_cast<const T*>(smem + p.dy_off);
  uint16_t* sarg = reinterpret_cast<uint16_t*>(smem + p.arg_off);
  const Tile g = locate<V>(blockIdx.x, s, p);
  const int tid = threadIdx.x;

  stage_tile<T, V>(g, smem, x, dy, s, p);
  cp_async_wait_all();
  __syncthreads();

  // 1. each window's first argmax tap
  for (int i = tid; i < p.wy * p.wx * p.cu; i += kThreads) {
    const int win = i / p.by_cu, u = i - win * p.cu;
    const int a = win / p.by_wx, bb = win - a * p.wx;
    if (a < g.wy && bb < g.wx && u < g.cu)
      window_argmax<T, V>(g, sx, sarg + i * V, a, bb, u, s, p);
  }
  __syncthreads();

  // 2. each pixel of the tile: the dy of the windows whose argmax it is.
  // A thread keeps a (column, access) lane and walks the tile's rows
  // rows_a_pass apart, so the windows along x are worked out once a lane
  const int64_t img = (int64_t)g.n * s.h * s.w;
  for (int slot = tid; slot < p.rows_a_pass * p.lanes; slot += kThreads) {
    const int r0 = slot / p.by_lanes, lane = slot - r0 * p.lanes;
    const int col = lane / p.by_cu, u = lane - col * p.cu;
    int tx = col;
    if (p.classes > 0) {  // class-major: tx = (col % classes) * sx + col / classes
      const int cls = col / p.by_classes;
      tx = (col - cls * p.classes) * s.sx + cls;
    }
    const int w = g.w0 + tx;
    if (w >= g.w1 || u >= g.cu) continue;
    const int xp = w + s.px;
    const int xa = first_window(xp, s.kw, s.sx, p.by_sx);
    const int xb = min(xp / p.by_sx, g.ox1);
    for (int h = g.h0 + r0; h < g.h1; h += p.rows_a_pass) {
      const int yp = h + s.py;
      pixel_grad<T, V>(g, sdy, sarg, yp, first_window(yp, s.kh, s.sy, p.by_sy),
                       min(yp / p.by_sy, g.oy1), xp, xa, xb, u,
                       dx + (img + (int64_t)h * s.w + w) * s.c + g.c0 + u * V,
                       s, p);
    }
  }
}

template <typename T, int V>
int launch(const void* x, const void* dy, void* dx, const Shape& s,
           const Plan& p, cudaStream_t stream) {
  auto kern = maxpool_bwd_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<p.tiles, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      s, p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int dispatch(const void* x, const void* dy, void* dx, const Shape& s, int th,
             int tw, int tc, int vec, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (vec != 1 && vec != kV) return cudaErrorInvalidValue;
  if (vec == kV && (s.c % kV != 0 || tc % kV != 0 || !aligned16(x) ||
                    !aligned16(dy) || !aligned16(dx)))
    return cudaErrorMisalignedAddress;
  const Plan p = make_plan(s, th, tw, tc, vec, (int)sizeof(T));
  if (p.smem > 232448 || p.tiles < 0) return cudaErrorInvalidConfiguration;
  return vec == kV ? launch<T, kV>(x, dy, dx, s, p, stream)
                   : launch<T, 1>(x, dy, dx, s, p, stream);
}

}  // namespace

// x (N, H, W, C), dy (N, OH, OW, C) and dx (N, H, W, C) contiguous, of one
// dtype (0 float32, 1 bf16, 2 float16); a tile th x tw x tc and the
// channels an access, vec (16 / element size, or 1), from ops/pool_bwd.py
// launch_plan.
extern "C" int mxt_maxpool_bwd(const void* x, const void* dy, void* dx, int n,
                               int h, int w, int c, int oh, int ow, int kh,
                               int kw, int sy, int sx, int py, int px, int th,
                               int tw, int tc, int vec, int dtype,
                               void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0 || kh <= 0 ||
      kw <= 0 || kh * kw > 255 || sy <= 0 || sx <= 0 || py < 0 || px < 0 ||
      th <= 0 || th > h || tw <= 0 || tw > w || tc <= 0 || tc > c)
    return cudaErrorInvalidValue;
  const Shape s{n, h, w, c, oh, ow, kh, kw, sy, sx, py, px};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, dy, dx, s, th, tw, tc, vec, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, dy, dx, s, th, tw, tc, vec, st);
  if (dtype == 2) return dispatch<__half>(x, dy, dx, s, th, tw, tc, vec, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
