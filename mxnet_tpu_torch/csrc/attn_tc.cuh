// Tensor-core pieces shared by the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the shared-memory tile layouts, the tile and
// row-scalar loaders, and the mma.sync and 16-bit wgmma instruction
// wrappers.  The cp.async, fence and descriptor primitives they are built
// on, the tf32 split and the tf32 wgmma instructions are in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// tiles of ES-byte elements (16-bit by default, 4 for tf32): rows of
// kCols = max(DB, 128 / ES) elements in 128-byte swizzled atoms of 128 / ES
// columns, [kCols / (128 / ES)][rows][128 / ES]; each tile starts on a
// 1024-byte boundary
template <int DB, int ES = 2>
struct Swizzled {
  static constexpr int kCols = DB < 128 / ES ? 128 / ES : DB;
  static constexpr int kElems = 16 / ES;  // elements per 16-byte chunk
  template <int R>
  __host__ __device__ static constexpr int bytes() { return R * kCols * ES; }
  // byte offset of 16-byte chunk c of row r in a tile of R rows
  template <int R>
  __device__ static uint32_t chunk(int r, int c) {
    return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
};

// float32 tiles: rows of DB floats padded to DB + 4, so that the fragment
// reads of mma.sync (8 rows x 4 columns, or 4 row pairs x 8 columns) fall
// in 32 distinct banks
template <int DB>
struct Padded {
  static constexpr int kCols = DB;
  static constexpr int kLd = DB + 4;
  static constexpr int kElems = 4;
  template <int R>
  __host__ __device__ static constexpr int bytes() { return R * kLd * 4; }
  template <int R>
  __device__ static uint32_t chunk(int r, int c) { return (r * kLd + c * 4) * 4; }
};

// rows [r0, r0 + R) of a contiguous (rows, d) array into the tile at dst,
// by the NT threads of the block: 16-byte cp.async copies where `vec`,
// else element by element through registers; zeros past `rows` and past
// column d
template <class L, int R, int NT, typename U>
__device__ __forceinline__ void load_tile(uint8_t* dst, const U* __restrict__ src,
                                          int r0, int rows, int d, bool vec) {
  constexpr int E = L::kElems;
  constexpr int C = L::kCols / E;  // chunks a row
  const uint32_t base = smem_u32(dst);
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C, gr = r0 + r;
    const uint32_t at = base + L::template chunk<R>(r, c);
    if (vec) {
      const bool ok = gr < rows && c * E < d;
      cp_async16(at, ok ? src + (int64_t)gr * d + c * E : src, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int col = c * E + e;
        const uint32_t x = gr < rows && col < d ? (uint32_t)src[(int64_t)gr * d + col] : 0u;
        if constexpr (sizeof(U) == 2)
          w[e >> 1] |= x << (16 * (e & 1));
        else
          w[e] = x;
      }
      st_shared_v4(at, w);
    }
  }
}

// R float32 row scalars from src[r0..] into dst, zeros past `rows`
template <int R, int NT>
__device__ __forceinline__ void load_row_scalars(float* dst, const float* __restrict__ src,
                                                 int r0, int rows) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const bool ok = r0 + i < rows;
    cp_async4(smem_u32(dst + i), ok ? src + r0 + i : src, ok);
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// ---- wgmma: bf16 (kF16 false) and float16

// d[64 x 64] += A[64 x 16] B[16 x 64]: A and B K-major in shared memory
#define MXT_WGMMA_SS_N64(TYPES)                                              \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                      \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "l"(db), "r"(1))

// d[64 x 32] += A[64 x 16] B[16 x 32], the same with N = 32
#define MXT_WGMMA_SS_N32(TYPES)                                              \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %18, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPES " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"                                     \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15])                                                          \
      : "l"(da), "l"(db), "r"(1))

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers, B MN-major in
// shared memory (transpose flag 1)
#define MXT_WGMMA_RS_N64(TYPES)                                              \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %37, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"        \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool kF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (kF16)
    MXT_WGMMA_SS_N64("f16.f16");
  else
    MXT_WGMMA_SS_N64("bf16.bf16");
}
template <bool kF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (kF16)
    MXT_WGMMA_SS_N32("f16.f16");
  else
    MXT_WGMMA_SS_N32("bf16.bf16");
}
template <bool kF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kF16)
    MXT_WGMMA_RS_N64("f16.f16");
  else
    MXT_WGMMA_RS_N64("bf16.bf16");
}

// the A fragments of accumulator-layout values p[64 x KB], rounded to
// bf16 or float16: the accumulator of n8 blocks 2c and 2c + 1 is the A
// fragment of k16 step c
template <bool kF16, int KB>
__device__ __forceinline__ void pack_a16(uint32_t (&a)[KB / 16][4], const float (&p)[KB / 2]) {
#pragma unroll
  for (int c = 0; c < KB / 16; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = p[8 * c + 2 * i], hi = p[8 * c + 2 * i + 1];
      if constexpr (kF16) {
        const __half2 h = __floats2half2_rn(lo, hi);
        a[c][i] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
        a[c][i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
}

// ---- 3xTF32 on mma.sync (split_tf32 and the tf32 wgmma: hopper.cuh)

// c[16 x 8] += a[16 x 8] b[8 x 8] in tf32, float32 accumulate
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as three tf32 products, the small terms first, from operands
// split already
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// the same, b split here
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32(c, ah, al, bh0, bh1, bl0, bl1);
}

}  // namespace tc

}  // namespace
