// PTX helpers shared by the Hopper (sm_90a) kernels of csrc/: cp.async
// copies into shared memory, predicated loads and shared stores, the
// fences between the generic and the async proxies, the wgmma group and
// descriptor primitives, and the float32-on-the-tensor-cores pieces that
// the attention kernels and the conv dW kernel share: the tf32 split of a
// float and the tf32 wgmma instructions.  Every piece of inline PTX
// outside the instruction macros of a kernel lives here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok (the
// src-size 0 form reads nothing; src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// the same for 4 bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// a float from global memory through the non-coherent cache, or 0 when
// !ok; volatile, so that the compiler keeps a load issued a stage ahead of
// its use where it is written
__device__ __forceinline__ float ldg_f32(const float* p, bool ok) {
  float v = 0.f;
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.f32 %0, [%1];\n"
      "}\n"
      : "+f"(v)
      : "l"(p), "r"((int)ok));
  return v;
}

// the same for four floats at a 16-byte aligned address
__device__ __forceinline__ void ldg_f32x4(float (&v)[4], const float* p, bool ok) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %5, 0;\n"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "+f"(v[0]), "+f"(v[1]), "+f"(v[2]), "+f"(v[3])
      : "l"(p), "r"((int)ok));
}

// what cp.async and st.shared wrote becomes visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor of a wgmma operand in 128-byte swizzled
// atoms (16-byte chunk c of a 128-byte row r stored at c ^ (r & 7)):
// start address, leading and stride byte offsets, swizzle mode 128 B.
// The operand's tile must start on a 1024-byte boundary (base offset 0).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// ---- 3xTF32: float32 products on the tensor cores

// x = hi + lo: hi is x rounded to tf32 on its bits, to nearest with ties
// away from zero (what cvt.rna.tf32.f32 gives for a finite x, but on the
// integer pipe: with cvt for both halves the backward kernels took 1.38
// times as long); lo = x - hi is exact in float32, and the tensor core
// reads it as tf32 by ignoring its low 13 bits (|lo| <= 2^-11 |x|, so the
// truncation drops less than 2^-21 |x|; rounding lo on the integer pipe
// too took 12 % longer).  Times: attn_bwd_probe.py at the training shape,
// PERF.md.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// tf32 wgmma, k8: the transpose flags exist for 16-bit types only, so
// both shared operands are K-major.  d[64 x 64] += A[64 x 8] B[8 x 64],
// A and B in shared memory
#define MXT_WGMMA_TF32_SS_N64                                                \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"                            \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "l"(db), "r"(1))

// d[64 x N] (+)= A[64 x 8] B[8 x N], A from registers (the fragment of
// mma.sync m16n8k8's A: rows g, g + 8 and columns t, t + 4 of the warp's
// 16 rows), B in shared memory; SCALE_D 0 overwrites d, 1 adds to it
#define MXT_WGMMA_TF32_RS_N16(SCALE_D)                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %13, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                       \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"                               \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))

#define MXT_WGMMA_TF32_RS_N24(SCALE_D)                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %17, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"                     \
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11])                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))

#define MXT_WGMMA_TF32_RS_N32(SCALE_D)                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %21, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15"                                                   \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15])                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))

#define MXT_WGMMA_TF32_RS_N64(SCALE_D)                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %37, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))

#define MXT_WGMMA_TF32_RS_N128(SCALE_D)                                      \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %69, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63"                                                   \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db) {
  MXT_WGMMA_TF32_SS_N64;
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  MXT_WGMMA_TF32_RS_N16(scale_d);
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[12], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  MXT_WGMMA_TF32_RS_N24(scale_d);
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  MXT_WGMMA_TF32_RS_N32(scale_d);
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  MXT_WGMMA_TF32_RS_N64(scale_d);
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  MXT_WGMMA_TF32_RS_N128(scale_d);
}

}  // namespace
