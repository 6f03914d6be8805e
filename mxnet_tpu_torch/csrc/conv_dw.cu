// Convolution backward-filter (dW) for Hopper (sm_90a), CUDA C++.
//
// Replaces mxnet_tpu/ops/pallas_conv.py::_dw_kernel_pertap (K1a) and
// ::_dw_kernel_im2col (K1b), the Pallas TPU kernels behind conv_dw_nhwc.
// It computes the same function for an NHWC input and OHWI weights
// (dilation dh x dw):
//   dW[o, r, s, i] = sum_{n,y,x} X[n, y*sy + r*dh - py, x*sx + s*dw - px, i]
//                                * dY[n, y, x, o]
// with taps outside the image reading as 0, so nothing is padded in device
// memory (the JAX wrapper pads x with jnp.pad).  With G groups the same
// product runs on each group's slice: group g's dW rows o = g*O/G ..
// (g+1)*O/G - 1 take channels g*I/G .. of x and g*O/G .. of dY, and dW is
// (O, KH, KW, I/G).  The JAX package sends a grouped dW to XLA
// (pallas_conv.py supported(): groups != 1); here every group is one more
// slice of the grid's y axis (the block reads x and dY at the group's
// channel offset with the full row strides I and O), so a grouped or
// depthwise (I/G = 1) convolution runs the same kernels as any other.
// The sum runs in float32 and dW is written in float32; the caller casts
// it to the weight's type.
//
// The algebra.  dW is an implicit GEMM, dW[o, m] = sum_p dY[p, o] *
// X^[p, m], over the reduction axis p = (n, y, x), K = N*OH*OW (1.6 M at
// the ResNet stem, 6,272 at stage 4); dY is read as a plain [P, O]
// row-major matrix, X^ is gathered from X.  The two formulations differ
// in what the rows m of a tile are:
//   - per-tap (K1a, the rule for I >= 128): input channels i of one tap
//     (r, s); the grid's z axis carries the tap;
//   - im2col (K1b, I < 128): consecutive rows of the flattened (r, s, i)
//     axis, so a narrow layer (I=3 at the stem: 147 rows; I=64 at 3x3: 576
//     rows) fills whole tiles.
// Both operands are MN-major in device memory: the channel axis is
// contiguous and p is outermost.
//
// bf16 x and dy (the training path) and float16 x and dy run on the tensor
// cores, conv_dw_wgmma_kernel, as the Pallas kernels run on the MXU: bf16
// (f16) products accumulated in float32.  The two types share the layout,
// the descriptors and the swizzle; only the wgmma's types differ
// (.f32.bf16.bf16 or .f32.f16.f16).
//   - A block computes a tile of 128 output channels o (wgmma's M) by 128
//     rows m (wgmma's N) with two consumer warpgroups, each holding its
//     float32 accumulator in registers: stacked along M, 64 x 128 each
//     (wgmma.mma_async.m64n128k16, 64 registers a thread), or, when O <=
//     64, a 64-channel tile with the warpgroups side by side along N, 64 x
//     64 each (m64n64k16).  Both operands come from shared memory: dY as
//     wgmma's A, M-major, X^ as its B, N-major, so both transpose flags
//     are set.
//   - Shared memory is a ring of 5 stages of 64 positions, 32 KB each: dY
//     as [2 atoms of 64 o][64 p][64 o] and X^ as [2 atoms of 64 m][64 p]
//     [64 m], each atom row 128 bytes with the 128-byte swizzle (16-byte
//     chunk c of row p stored at c ^ (p & 7)).  The wgmma descriptors say:
//     start address, LBO = 8 KB (the next 64-wide atom along M or N), SBO
//     = 1 KB (the next 8 positions), swizzle 128 B; one k16 step is +2 KB.
//   - Loads.  Thread t owns the 16-byte chunk t % 16 of the 128 columns
//     of both tiles and positions t / 16 + 16 j (j < 4) of a stage, so its
//     columns' channel and tap offsets are fixed for the whole reduction
//     and only the positions' (n, y, x) advance, incrementally, by 64 a
//     stage.  Where the channel count is a multiple of 8 (every ResNet-50
//     dY, X at I >= 8), a chunk is 8 channels of one tap and loads by
//     cp.async.cg 16 bytes with the src-size zero-fill form for taps in the
//     padding, channels past I or O and positions past the chunk.  Where
//     it is not (the stem's I = 3: a (p, r) row of 21 bf16 at any
//     alignment; O = 100), the same chunk is filled from registers, one
//     bf16 per element, also masked; X's elements are loaded a stage ahead
//     of their store, so their latency hides behind a stage (loaded and
//     stored in one step, or gathered a warp per tap row with 2-byte
//     stores, the stem ran about twice as long in trials on an H100).
//     The wrapper picks the variant by the shape (ops/conv_dw.py
//     launch_plan).
//   - The pipeline.  Stage k is loaded into slot k % 5 three stages ahead;
//     each step waits for its own copies (cp.async.wait_group), fences
//     them to the async proxy (fence.proxy.async.shared::cta), syncs the
//     block, issues the load of stage k + 3 into the slot that stage k - 2
//     used, then four wgmmas on stage k, and waits until only those are in
//     flight (wgmma.wait_group 1), so the tensor cores always have the
//     next product queued while the loads of three stages are in flight.
//     No branch encloses a wgmma: ptxas serializes wgmmas in a divergent
//     path (its warning C7518).
//   - Bound on the H100: about 1 TFLOP of bf16 products a ResNet-50 step
//     (989 TFLOP/s: 1 ms) against 0.1-0.4 GB of x and dy a convolution
//     (3.35 TB/s); stage 1's 1x1 and 3x3 convolutions at 64 channels and
//     the stem are bound by bytes, the rest by operations.  This kernel
//     reaches 120-330 TFLOP/s at ResNet-50's K1a shapes: a 128 x 128
//     tile does 64 flops for every byte it loads from L2, x is loaded
//     again for every tap (9 times at 3x3), and the split-K partials,
//     the second pass and the per-stage barrier cost about as much as
//     the products (conv_dw_probe.py --parts; PERF.md).  A ring of 4 or
//     6 stages, two blocks an SM with 3 stages, and 128-position stages
//     were each no faster in trials on an H100.
//
// float32 x and dy (SSD300's training step, LeNet, the ConvLSTM cell, the
// card's gradient checks) run on the tensor cores too, by 3xTF32 with
// float32 accuracy, conv_dw_tf32_kernel: x = hi + lo, hi rounded to tf32
// on the integer pipe (split_tf32, hopper.cuh), lo = x - hi read as tf32;
// each product lo*hi + hi*lo + hi*hi, the small terms first (what the
// lo*lo term and the tf32 reading of lo drop is below 2^-20 of a product).
//   - tf32 wgmma has no transpose flag: a shared operand must be K-major,
//     positions p contiguous, while x and dy hold the channel contiguous.
//     So one operand comes from registers (the RS form): wgmma's A, the R
//     operand, is loaded as it lies by cp.async, float32 [32 p][128 rows]
//     padded to rows of 136 floats (the fragment reads, rows g and
//     columns t of a warp, fall in 32 distinct banks), 16 bytes where the
//     channel count is a multiple of 4, else 4; each thread reads its
//     fragments (rows g, g + 8, positions t, t + 4 of each k8 step) and
//     splits them once, so every element of R is split once.  Only B, the
//     S operand, is transposed: each thread loads four channels of one
//     position into registers a stage ahead (16 bytes, or one float
//     each), splits them once and stores hi and lo into K-major tiles of
//     32 positions (one 128-byte row a channel, 128-byte swizzle); a warp
//     stores two 4-channel chunks of 16 positions, so its stores fall in
//     32 distinct banks.  The other option, both operands transposed on
//     the tensor cores' shared path, reads A three times a k8 step from
//     shared memory and stores both operands twice.
//   - Which operand is which follows O.  O > 64 ("wide"): R = dY, a tile
//     of 128 output channels on M (two warpgroups of 64), S = X^, 128 rows
//     m on N (m64n128k8).  O <= 64 ("narrow"; SSD300's loc heads have O =
//     16 and 24): R = X^, 128 rows m on M, S = dY, all O channels on N,
//     padded to 16, 24, 32 or 64 (m64nNk8), so a narrow layer does not
//     spend a 64-row tile on 16 channels.  A warp loads R as 32 chunks of
//     4 rows at one position, but X^ by 4 bytes (I = 3: 27 of 128 rows at
//     SSD300's conv1_1) as one chunk of 32 positions, so that whole warps
//     skip the chunks past the rows' end.
//   - A ring of 4 slots of 32 positions (wide: 49 KB a slot, 197 KB; one
//     block an SM): stage k + 2 is filled while the products of stage k
//     run.  A stage's 12 wgmmas (4 k8 steps x 3) start a fresh float32
//     sum, which is added to the running sum in registers (round to
//     nearest) once they are done: the tensor core's own additions then
//     span 32 positions, not the whole chunk.
//   - Trials on an H100 (conv_dw_probe.py --variant, K1a and K1b
//     summed over SSD300's step; PERF.md): a ring of 3 slots (wide), K1a
//     26.3 ms against 24.2; 6 slots (narrow), no faster; the S loads two
//     or three stages ahead, moved from register to register each stage,
//     K1b 11.0 ms against 8.0 (each move waits for a load in flight); two
//     stages summed on the tensor cores a flush, no faster; X^ by 4 bytes
//     staged in registers a stage ahead, 32 chunks a warp, conv1_1 1.84
//     ms, by 4-byte cp.async 1.88, a chunk a warp 1.02; skipping the
//     loads of chunks past O or the rows' end by a branch in every load
//     path, K1a 36.2 ms against 23.5.
//   - Bound on the H100: float32-accurate work on the tensor cores runs at
//     most at 495 / 3 = 165 TFLOP/s (the CUDA cores' float32 peak is 67).
//
// Split-K.  The Pallas kernels carry the accumulator across a sequential
// image grid.  Hopper blocks run in no order, and the stem has 64 x 147
// outputs over a 1.6 M-term sum, so the reduction is split with a fixed
// partition: block (tile, split) sums its chunk of p in order (a
// multiple of the stage, 64 positions for bf16 and 32 for float32, only
// the last chunk shorter) and writes a float32 partial to a workspace
// laid out as [split][o][m]; a second kernel sums the partials of each
// output in split order and writes dW.  With one split the kernel writes
// dW itself and the second launch is skipped.  No atomics, so dW repeats
// bit for bit.  The split count comes from the caller (ops/conv_dw.py
// launch_plan), chosen to fill the 132 SMs in whole waves.  Ragged edges
// (I=3, O not a multiple of the tile, 7x7 taps at the border, a partial
// last chunk) are masked in the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Shape {
  int n, h, w, ci;        // x; ci: the channels of one group (I/G)
  int oh, ow, co;         // dy; co: the channels of one group (O/G)
  int kh, kw, sy, sx, py, px;
  int dil_h, dil_w;       // dilation: tap (r, s) lies r*dil_h, s*dil_w away
  int mt;                 // rows of dW^T: kh * kw * ci
  int splits, chunk;      // split-K: chunk positions per split
  int groups;             // G
  int xs, ys;             // row strides of x (I = G*ci) and dy (O = G*co)
};

// the tiles of output channels of one group, and the group and first
// output channel (within the group) of grid row y
__device__ __forceinline__ void group_tile(const Shape& s, int tile_o, int& g,
                                           int& o0) {
  const int o_tiles = (s.co + tile_o - 1) / tile_o;
  g = blockIdx.y / o_tiles;
  o0 = (blockIdx.y % o_tiles) * tile_o;
}

// A running reduction position: p and its (n, y, x).
struct Pos {
  int p, n, y, x;
  __device__ __forceinline__ void start(int at, const Shape& s) {
    p = at;
    n = at / (s.oh * s.ow);
    const int rem = at % (s.oh * s.ow);
    y = rem / s.ow;
    x = rem % s.ow;
  }
};

// positions a stage of BK holds, as whole rows (y) and the rest (x)
struct Step {
  int y, x;
};

// q advanced by one stage of BK positions
template <int BK>
__device__ __forceinline__ void step_by(Pos& q, const Step& st, const Shape& s) {
  q.p += BK;
  q.x += st.x;
  q.y += st.y;
  if (q.x >= s.ow) {
    q.x -= s.ow;
    ++q.y;
  }
  while (q.y >= s.oh) {
    q.y -= s.oh;
    ++q.n;
  }
}

// ------------------------------------ bf16 and float16: the tensor cores

namespace tc {

constexpr int kBN = 128;                     // rows m of a tile
constexpr int kBK = 64;                      // positions p of a stage
constexpr int kStages = 5;                   // slots of the ring
constexpr int kAhead = kStages - 2;          // stages loaded ahead
constexpr int kThreads = 256;                // two warpgroups
constexpr int kRowsPerThread = kBK * 16 / kThreads;  // 4 positions
constexpr int kAtomBytes = kBK * 128;        // 64 positions x 64 bf16
constexpr int kTileBytes = 2 * kAtomBytes;   // one operand of a stage
constexpr int kStageBytes = 2 * kTileBytes;  // dY, then X
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment

__device__ __forceinline__ void step(Pos& q, const Step& st, const Shape& s) {
  step_by<kBK>(q, st, s);
}

// shared-memory matrix descriptor of an MN-major operand in 128-byte
// swizzled atoms of 64 (M or N) x 8 (K) bf16: LBO the next atom along M
// or N, SBO the next 8 positions
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return wgmma_desc(addr, kAtomBytes, 1024);
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], bf16 (or f16) in, float32
// accumulate; A (dY) M-major and B (X) N-major: transpose flags 1, 1.
// TYPES names the input type pair of the instruction.
#define MXT_WGMMA_M64N128K16(TYPES)                                          \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPES " {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "%64, %65, p, 1, 1, 1, 1;\n"                                           \
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
      : "l"(da), "l"(db), "r"(1))

// D[64 x 64] += A[64 x 16] * B[16 x 64], the same with N = 64
#define MXT_WGMMA_M64N64K16(TYPES)                                           \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                            \
      "%32, %33, p, 1, 1, 1, 1;\n"                                           \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "l"(db), "r"(1))

// kF16: the operands are float16, else bf16 (the same 2-byte layout, the
// same descriptors and swizzle; only the instruction's types differ)
template <bool kF16>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (kF16)
    MXT_WGMMA_M64N128K16("f16.f16");
  else
    MXT_WGMMA_M64N128K16("bf16.bf16");
}
template <bool kF16>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (kF16)
    MXT_WGMMA_M64N64K16("f16.f16");
  else
    MXT_WGMMA_M64N64K16("bf16.bf16");
}

// a bf16 load that the compiler keeps where it is written: the gather of
// a stage is issued a whole stage before its stores, and a plain __ldg
// may be sunk to its use
__device__ __forceinline__ uint32_t ldg_u16(const uint16_t* p, bool ok) {
  uint16_t v = 0;
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u16 %0, [%1];\n"
      "}\n"
      : "+h"(v)
      : "l"(p), "r"((int)ok));
  return v;
}

// a tap's offsets (r*dil_h - py, s*dil_w - px) packed as the halves of one
// int
__device__ __forceinline__ int tap_dy(int dyx) { return dyx >> 16; }
__device__ __forceinline__ int tap_dx(int dyx) { return (int)(short)(dyx & 0xffff); }

// kF16: float16 operands, else bf16; kVecA: dY by 16-byte cp.async (O %
// 8 == 0), else from registers;
// kVecB: X the same (I % 8 == 0); kWideO: a tile of 128 output channels,
// the two warpgroups stacked along M (64 each, N = 128), else of 64
// (O <= 64), the warpgroups side by side along N (N = 64 each).  Grid: x
// row tiles, y o tiles, z split-major (split, tap) for per-tap, split for
// im2col.
template <bool kF16, bool kIm2col, bool kVecA, bool kVecB, bool kWideO>
__global__ void __launch_bounds__(kThreads, 1)
conv_dw_wgmma_kernel(const uint16_t* __restrict__ x_all,
                     const uint16_t* __restrict__ dy_all,
                     float* __restrict__ out, Shape s, Step st) {
  constexpr int kM = kWideO ? 128 : 64;  // output channels of the tile
  constexpr int kN = kWideO ? 128 : 64;  // rows of a warpgroup's product
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
  int g, o0;
  group_tile(s, kM, g, o0);
  // the group's channels: x and dY from its channel offset, rows of
  // s.xs and s.ys elements
  const uint16_t* const x = x_all + (int64_t)g * s.ci;
  const uint16_t* const dy = dy_all + (int64_t)g * s.co;
  const uint16_t* xr = x;
  const uint16_t* dyr = dy;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int taps = s.kh * s.kw;
  const int split = kIm2col ? blockIdx.z : blockIdx.z / taps;
  const int tap = kIm2col ? 0 : blockIdx.z % taps;
  const int m0 = blockIdx.x * kBN;  // im2col: on the flattened axis;
                                    // per-tap: a channel of the tap
  const int k_total = s.n * s.oh * s.ow;
  const int p_begin = split * s.chunk;
  const int p_end = min(p_begin + s.chunk, k_total);
  const int stages = (p_end - p_begin + kBK - 1) / kBK;

  // this thread's chunk column and first position of a stage
  const int cc = tid & 15;
  const int row0 = tid >> 4;
  const uint32_t chunk_off = (cc >> 3) * kAtomBytes + row0 * 128 +
                             (((cc & 7) ^ (row0 & 7)) << 4);
  const int oc = o0 + cc * 8;  // its first output channel
  const bool a_mine = kWideO || cc < 8;  // a 64-channel tile has one atom

  // the X rows of its chunk (per element when read from registers): tap
  // offsets (dyo, dxo) packed as 16-bit halves and the channel, fixed for
  // the whole reduction; a row past the tile's edge gets dyo = -16384
  // (never in the image)
  constexpr int kElems = kVecB ? 1 : 8;
  int b_dyx[kElems], b_i[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int m = m0 + cc * 8 + e;
    int t = tap, i = m;
    bool ok = m < s.ci;
    if (kIm2col) {
      ok = m < s.mt;
      t = ok ? m / s.ci : 0;
      i = ok ? m % s.ci : 0;
    }
    const int dyo = ok ? (t / s.kw) * s.dil_h - s.py : -16384;
    const int dxo = (t % s.kw) * s.dil_w - s.px;
    b_dyx[e] = (int)(((unsigned)dyo << 16) | ((unsigned)dxo & 0xffffu));
    b_i[e] = ok ? i : 0;
  }

  Pos pos[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    pos[j].start(p_begin + row0 + 16 * j, s);

  // X from registers: each thread loads its chunk's 8 rows at its 4
  // positions of a stage one stage ahead of their stores (xe), from
  // positions xpos, so the loads' latency hides behind a stage
  Pos xpos[kRowsPerThread];
  uint32_t xe[kRowsPerThread][8];
  auto gather_elems = [&]() {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const Pos& q = xpos[j];
      const bool pv = q.p < p_end;
      const int yb = q.y * s.sy, xb = q.x * s.sx;
      const int64_t pix = (int64_t)(q.n * s.h + yb) * s.w + xb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int dyo = tap_dy(b_dyx[e]), dxo = tap_dx(b_dyx[e]);
        const bool ok = pv && (unsigned)(yb + dyo) < (unsigned)s.h &&
                        (unsigned)(xb + dxo) < (unsigned)s.w;
        xe[j][e] = ldg_u16(xr + (pix + dyo * s.w + dxo) * s.xs + b_i[e], ok);
      }
      step(xpos[j], st, s);
    }
  };
  if constexpr (!kVecB) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) xpos[j] = pos[j];
    gather_elems();
  }

  // load this thread's part of a stage into slot `slot`, then step the
  // positions to the next stage
  auto fill = [&](int slot) {
    const uint32_t a_base = sbase + slot * kStageBytes + chunk_off;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const Pos& q = pos[j];
      const bool pv = q.p < p_end;
      const uint32_t dst_a = a_base + j * 16 * 128;
      const uint32_t dst_b = dst_a + kTileBytes;
      if constexpr (kVecA) {
        const bool ok = pv && oc < s.co;
        if (a_mine)
          cp_async16(dst_a, ok ? dy + (int64_t)q.p * s.ys + oc : dy, ok);
      } else if (a_mine) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int64_t at = (int64_t)q.p * s.ys + oc + e;
          const uint32_t lo = pv && oc + e < s.co ? __ldg(dyr + at) : 0u;
          const uint32_t hi = pv && oc + e + 1 < s.co ? __ldg(dyr + at + 1) : 0u;
          v[e >> 1] = lo | (hi << 16);
        }
        st_shared_v4(dst_a, v);
      }
      if constexpr (kVecB) {
        const int yy = q.y * s.sy + tap_dy(b_dyx[0]);
        const int xx = q.x * s.sx + tap_dx(b_dyx[0]);
        const bool ok = pv && (unsigned)yy < (unsigned)s.h &&
                        (unsigned)xx < (unsigned)s.w;
        cp_async16(dst_b,
                   ok ? x + ((int64_t)(q.n * s.h + yy) * s.w + xx) * s.xs + b_i[0]
                      : x,
                   ok);
      } else {
        const uint32_t v[4] = {xe[j][0] | xe[j][1] << 16, xe[j][2] | xe[j][3] << 16,
                               xe[j][4] | xe[j][5] << 16, xe[j][6] | xe[j][7] << 16};
        st_shared_v4(dst_b, v);
      }
    }
    if constexpr (!kVecB) gather_elems();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) step(pos[j], st, s);
  };

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int t = 0; t < kAhead; ++t) {
    if (t < stages) fill(t);
    cp_async_commit();
  }
  // A: the warpgroup's 64 channels of dY (kWideO) or the one atom; B: all
  // 128 rows (kWideO) or the warpgroup's 64
  const uint32_t a_off = kWideO ? wg * kAtomBytes : 0;
  const uint32_t b_off = kTileBytes + (kWideO ? 0 : wg * kAtomBytes);
#pragma unroll 1
  for (int k = 0; k < stages; ++k) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    fence_proxy_async();
    // the slot of stage k - 2: every warpgroup has waited for its products
    if (k + kAhead < stages) fill((k + kAhead) % kStages);
    cp_async_commit();
    const uint32_t slot = sbase + (k % kStages) * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<kF16>(acc, desc(slot + a_off + kk * 2048), desc(slot + b_off + kk * 2048));
    wgmma_commit();
    wgmma_wait<1>();
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  fence_acc(acc);

  // the partial of this split in OHWI order, out[o][m] (the group's rows
  // from g*O/G): thread (warp w, lane l) of warpgroup wg holds rows
  // w*16 + l/4 (+8) and columns 8j + 2(l%4) (+1) of wg's product
  float* dst = out + ((int64_t)split * s.groups + g) * s.co * s.mt;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int m_lim = kIm2col ? s.mt : s.ci;
  const int m_abs = kIm2col ? m0 : tap * s.ci + m0;
  const int o_first = o0 + (kWideO ? wg * 64 : 0) + warp * 16 + (lane >> 2);
  const int c_first = (kWideO ? 0 : wg * 64) + (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = o_first + 8 * h;
    if (o >= s.co) continue;
    float* row = dst + (int64_t)o * s.mt + m_abs;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c_first + j * 8 + c;
        if (m0 + col < m_lim) row[col] = acc[j * 4 + h * 2 + c];
      }
    }
  }
}

}  // namespace tc

// ------------------------------- float32: 3xTF32 on the tensor cores

namespace f32 {

constexpr int kBK = 32;                  // positions p of a stage: one
                                         // 128-byte row of tf32 along K
constexpr int kRows = 128;               // rows of the register operand
                                         // (wgmma's M): two warpgroups
constexpr int kLdR = kRows + 8;          // its tile's row stride, floats
constexpr int kRBytes = kBK * kLdR * 4;  // 17 KB
constexpr int kThreads = 256;
constexpr int kRLoads = kBK * kRows / 4 / kThreads;  // 4 chunks a thread
constexpr int kStages = 4;               // slots of the ring
constexpr int kAhead = kStages - 2;      // stages loaded ahead

// the ring for an S operand of N rows: slots of the S operand's hi and lo
// tiles (N rows of kBK tf32, K-major, 128-byte swizzle; each starts on a
// 1024-byte boundary), then the R operand's float32 tile [kBK][kLdR]
template <int N>
struct Ring {
  static constexpr int kSBytes = N * 128;
  static constexpr int kSlot = 2 * kSBytes + kRBytes;
  static constexpr int kSmem = kStages * kSlot + 1024;  // + alignment
};

// byte offset of element (row, k) in a K-major tile of 128-byte rows:
// 16-byte chunk c of row r stored at c ^ (r & 7)
__device__ __forceinline__ uint32_t kmajor(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4;
}

// four consecutive rows of X^ (a chunk) from row m of the tile's axis:
// the tap (r, s) and channel i of its first row, and how many of the
// four lie before the axis's end (<= 0: none)
struct XChunk {
  int r, s, i, left;
};

template <bool kIm2col>
__device__ __forceinline__ XChunk x_chunk(int m, int tap, const Shape& s) {
  XChunk c;
  if (kIm2col) {
    const int mm = m < s.mt ? m : 0;
    const int t = mm / s.ci;
    c.i = mm % s.ci;
    c.r = t / s.kw;
    c.s = t % s.kw;
    c.left = s.mt - m;
  } else {
    c.r = tap / s.kw;
    c.s = tap % s.kw;
    c.i = m;
    c.left = s.ci - m;
  }
  return c;
}

// f(e, address, ok) for X^'s four rows e of chunk c at position q (row e
// is X[n, y*sy + r*dh - py, x*sx + s*dw - px, i]; ok false in the
// padding, past the axis and for !pv): with `vec` once, for the 16 bytes
// of channels i..i+3 of one tap (e = 0), else once a row, the tap and
// channel stepped along the flattened (r, s, i) axis
template <bool kIm2col, class F>
__device__ __forceinline__ void x_rows(const float* __restrict__ x, const Pos& q, bool pv,
                                       const XChunk& c, const Shape& s, bool vec, F&& f) {
  const int yb = q.y * s.sy - s.py, xb = q.x * s.sx - s.px;
  int r = c.r, ss = c.s, i = c.i;
#pragma unroll
  for (int e = 0; e < (vec ? 1 : 4); ++e) {
    const int yy = yb + r * s.dil_h, xx = xb + ss * s.dil_w;
    const bool ok = pv && e < c.left && (unsigned)yy < (unsigned)s.h &&
                    (unsigned)xx < (unsigned)s.w;
    f(e, ok ? x + ((int64_t)(q.n * s.h + yy) * s.w + xx) * s.xs + i : x, ok);
    ++i;
    if (kIm2col && i == s.ci) {
      i = 0;
      if (++ss == s.kw) {
        ss = 0;
        ++r;
      }
    }
  }
}

// the same for dY's four rows o..o+3 at position p (ok false past O and
// for !pv): with `vec` (O % 4 == 0) once, else once a row
template <class F>
__device__ __forceinline__ void dy_rows(const float* __restrict__ dy, int p, bool pv, int o,
                                        const Shape& s, bool vec, F&& f) {
  const float* row = dy + (int64_t)p * s.ys + o;
#pragma unroll
  for (int e = 0; e < (vec ? 1 : 4); ++e) {
    const bool ok = pv && o + e < s.co;
    f(e, ok ? row + e : dy, ok);
  }
}

// kN: the S operand's rows.  128: "wide" (O > 64), the R operand is dY (a
// tile of 128 output channels on wgmma's M) and the S operand X^ (128
// rows m on N); 16, 24, 32 or 64: "narrow" (O <= kN), R is X^ (128 rows
// m on M) and S is dY (all O channels on N).  kVecR: the R operand by
// 16-byte cp.async (dY: O % 4 == 0; X: I % 4 == 0), else by 4-byte
// cp.async; vec_s: the S operand's loads are 16 bytes (the same
// conditions), else 4.  Grid: x row tiles of 128, y o tiles (1 when
// narrow), z split-major (split, tap) for per-tap, split for im2col.
template <bool kIm2col, int kN, bool kVecR>
__global__ void __launch_bounds__(kThreads, 1)
conv_dw_tf32_kernel(const float* __restrict__ x_all, const float* __restrict__ dy_all,
                    float* __restrict__ out, Shape s, Step st, int vec_s) {
  constexpr bool kWide = kN == 128;
  int g, o0;
  group_tile(s, kN, g, o0);
  // the group's channels, as in the 16-bit kernel
  const float* const x = x_all + (int64_t)g * s.ci;
  const float* const dy = dy_all + (int64_t)g * s.co;
  using G = Ring<kN>;
  constexpr int kSChunks = kN / 4;  // chunks of the S operand at a position
  // S loads a thread: (chunk pair, half of the stage's positions) blocks
  // of 32 loads, one a warp
  constexpr int kSLoads = kN >= 32 ? kN / 32 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int taps = s.kh * s.kw;
  const int split = kIm2col ? blockIdx.z : blockIdx.z / taps;
  const int tap = kIm2col ? 0 : blockIdx.z % taps;
  const int m0 = blockIdx.x * kRows;  // im2col: on the flattened axis;
                                      // per-tap: a channel of the tap
  const int k_total = s.n * s.oh * s.ow;
  const int p_begin = split * s.chunk;
  const int p_end = min(p_begin + s.chunk, k_total);
  const int stages = (p_end - p_begin + kBK - 1) / kBK;

  // R loads, chunk r_chunk(j) (rows 4c..4c+3 of the tile) at position
  // r_pos(j) of a stage, j < kRLoads: a warp loads 32 chunks of one
  // position, whose 16-byte (or 4-byte) pieces lie side by side; but X^
  // by 4 bytes (I % 4 != 0) one chunk of 32 positions, so that a chunk
  // wholly past the axis's end (I = 3 fills 7 chunks of 32) is skipped by
  // whole warps
  constexpr bool kWarpChunk = !kVecR && !kWide;
  constexpr int kRX = kWarpChunk ? kRLoads : 1;  // chunks a thread loads
  constexpr int kRP = kWarpChunk ? 1 : kRLoads;  // positions a thread loads
  auto r_chunk = [&](int j) { return kWarpChunk ? (tid >> 5) + 8 * j : lane; };
  auto r_pos = [&](int j) { return kWarpChunk ? lane : (tid >> 5) + 8 * j; };
  // S loads: position sp of a stage, chunks sc[j] (a warp 2 chunks of 16
  // positions, so that the transposed stores fall in 32 distinct banks)
  const int sp = 16 * ((tid >> 5) & 1) + (lane >> 1);
  int sc[kSLoads];
  bool s_on[kSLoads];
#pragma unroll
  for (int j = 0; j < kSLoads; ++j) {
    sc[j] = 2 * ((tid >> 6) + 4 * j) + (tid & 1);
    s_on[j] = (tid >> 5) + 8 * j < kSChunks;
  }

  // the R operand's positions, at the stage being filled (wide: dY at pr
  // + r_pos(j); narrow: X^ at qr); the S operand's, at the stage being
  // loaded into registers (wide: X^ at qs; narrow: dY at ps)
  int pr = p_begin, ps = p_begin + sp;
  Pos qs, qr[kWide ? 1 : kRP];
  XChunk xs[kWide ? kSLoads : 1], xr[kWide ? 1 : kRX];
  if constexpr (kWide) {
    qs.start(ps, s);
#pragma unroll
    for (int j = 0; j < kSLoads; ++j) xs[j] = x_chunk<kIm2col>(m0 + 4 * sc[j], tap, s);
  } else {
#pragma unroll
    for (int j = 0; j < kRP; ++j) qr[j].start(p_begin + r_pos(j), s);
#pragma unroll
    for (int j = 0; j < kRX; ++j) xr[j] = x_chunk<kIm2col>(m0 + 4 * r_chunk(j), tap, s);
  }
  // the S operand's values of the stage filled next, in registers
  float sv[kSLoads][4];
  auto gather = [&]() {
#pragma unroll
    for (int j = 0; j < kSLoads; ++j) {
      float(&v)[4] = sv[j];
      auto one = [&](int e, const float* p, bool ok) {
        if (vec_s)
          ldg_f32x4(v, p, ok);
        else
          v[e] = ldg_f32(p, ok);
      };
      if constexpr (kWide)
        x_rows<kIm2col>(x, qs, s_on[j] && qs.p < p_end, xs[j], s, vec_s, one);
      else
        dy_rows(dy, ps, s_on[j] && ps < p_end, 4 * sc[j], s, vec_s, one);
    }
    if constexpr (kWide)
      step_by<kBK>(qs, st, s);
    else
      ps += kBK;
  };

  // this thread's part of the next stage into slot `slot`: R by cp.async
  // at its positions, which then step to the following stage; S from
  // registers, split and transposed, and the S loads of the following
  // stage issued
  auto fill = [&](int slot) {
    const uint32_t s_hi = sbase + slot * G::kSlot;
#pragma unroll
    for (int j = 0; j < kRLoads; ++j) {
      const uint32_t dst = s_hi + 2 * G::kSBytes + (r_pos(j) * kLdR + 4 * r_chunk(j)) * 4;
      auto copy = [&](int e, const float* p, bool ok) {
        if (kVecR)
          cp_async16(dst, p, ok);
        else
          cp_async4(dst + 4 * e, p, ok);
      };
      if constexpr (kWide) {
        const int p = pr + r_pos(j);
        dy_rows(dy, p, p < p_end, o0 + 4 * r_chunk(j), s, kVecR, copy);
      } else {
        const XChunk& c = xr[kWarpChunk ? j : 0];
        const Pos& q = qr[kWarpChunk ? 0 : j];
        if (!kWarpChunk || c.left > 0) x_rows<kIm2col>(x, q, q.p < p_end, c, s, kVecR, copy);
      }
    }
    pr += kBK;
    if constexpr (!kWide) {
#pragma unroll
      for (int j = 0; j < kRP; ++j) step_by<kBK>(qr[j], st, s);
    }
#pragma unroll
    for (int j = 0; j < kSLoads; ++j) {
      if (!s_on[j]) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split_tf32(sv[j][e], hi, lo);
        const uint32_t at = s_hi + kmajor(4 * sc[j] + e, sp);
        st_shared_u32(at, hi);
        st_shared_u32(at + G::kSBytes, lo);
      }
    }
    gather();
  };

  // acc: the running sum; part: one stage's products on the tensor cores,
  // added to acc in float32 (round to nearest) once they are done
  float acc[kN / 2], part[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = part[i] = 0.f;

  gather();
#pragma unroll 1
  for (int t = 0; t < kAhead; ++t) {
    if (t < stages) fill(t);
    cp_async_commit();
  }
  // the A fragment rows of this thread (warpgroup wg's 64 rows, warp w's
  // 16): rows r_a, r_a + 8 and positions t, t + 4 of each k8 step
  const int r_a = wg * 64 + warp * 16 + (lane >> 2), k_a = lane & 3;
#pragma unroll 1
  for (int k = 0; k < stages; ++k) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    fence_proxy_async();
    const uint32_t s_hi = sbase + (k % kStages) * G::kSlot;
    const float* R = reinterpret_cast<const float*>(smem + (k % kStages) * G::kSlot +
                                                    2 * G::kSBytes) +
                     k_a * kLdR + r_a;
    uint32_t ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float* c = R + kk * 8 * kLdR;
      split_tf32(c[0], ah[kk][0], al[kk][0]);
      split_tf32(c[8], ah[kk][1], al[kk][1]);
      split_tf32(c[4 * kLdR], ah[kk][2], al[kk][2]);
      split_tf32(c[4 * kLdR + 8], ah[kk][3], al[kk][3]);
    }
    // three products a k8 step, the small terms first; the stage's first
    // overwrites part
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t bh = wgmma_desc(s_hi + kk * 32, 16, 1024);
      const uint64_t bl = wgmma_desc(s_hi + G::kSBytes + kk * 32, 16, 1024);
      wgmma_tf32_rs(part, al[kk], bh, kk > 0);
      wgmma_tf32_rs(part, ah[kk], bl);
      wgmma_tf32_rs(part, ah[kk], bh);
    }
    wgmma_commit();
    // the slot of stage k - 2: its products are done
    if (k + kAhead < stages) fill((k + kAhead) % kStages);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // the partial of this split in OHWI order, out[o][m] (the group's rows
  // from g*O/G): thread (warp w, lane l) of warpgroup wg holds M rows
  // wg*64 + w*16 + l/4 (+8) and N columns 8j + 2(l%4) (+1)
  float* dst = out + ((int64_t)split * s.groups + g) * s.co * s.mt;
  const int m_lim = kIm2col ? s.mt : s.ci;
  const int m_abs = kIm2col ? 0 : tap * s.ci;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + 8 * h;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * k_a + c;
        const int o = kWide ? o0 + r : col;
        const int m = kWide ? m0 + col : m0 + r;
        if (o < s.co && m < m_lim) dst[(int64_t)o * s.mt + m_abs + m] = acc[4 * j + 2 * h + c];
      }
    }
  }
}

}  // namespace f32

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

int launch_reduce(const float* ws, float* dw, const Shape& s,
                  cudaStream_t stream) {
  const int64_t elems = (int64_t)s.groups * s.co * s.mt;
  const int64_t blocks = (elems + 255) / 256;
  conv_dw_reduce_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                          stream>>>(ws, dw, elems, s.splits);
  return cudaGetLastError();
}

template <bool kIm2col, int kN, bool kVecR>
int launch_f32(const void* x, const void* dy, float* ws, float* dw,
               const Shape& s, bool vec_s, cudaStream_t stream) {
  const int m_rows = kIm2col ? s.mt : s.ci;
  const int64_t gz = kIm2col ? (int64_t)s.splits
                             : (int64_t)s.kh * s.kw * s.splits;
  const int64_t gy = (int64_t)(s.co + kN - 1) / kN * s.groups;
  if (gz > 65535 || gy > 65535 || s.chunk % f32::kBK != 0)
    return cudaErrorInvalidConfiguration;
  auto kernel = f32::conv_dw_tf32_kernel<kIm2col, kN, kVecR>;
  constexpr int kSmem = f32::Ring<kN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((m_rows + f32::kRows - 1) / f32::kRows, (unsigned)gy, (unsigned)gz);
  kernel<<<grid, f32::kThreads, kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      s.splits == 1 ? dw : ws, s, Step{f32::kBK / s.ow, f32::kBK % s.ow},
      vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.splits == 1) return err;
  return launch_reduce(ws, dw, s, stream);
}

template <bool kIm2col, int kN>
int launch_f32_r(const void* x, const void* dy, float* ws, float* dw,
                 const Shape& s, bool vec_r, bool vec_s, cudaStream_t st) {
  return vec_r ? launch_f32<kIm2col, kN, true>(x, dy, ws, dw, s, vec_s, st)
               : launch_f32<kIm2col, kN, false>(x, dy, ws, dw, s, vec_s, st);
}

// float32: tile_n the S operand's rows (128: R = dY, S = X^; 16, 24, 32,
// 64: R = X^, S = dY), vec_dy and vec_x the 16-byte loads of each
template <bool kIm2col>
int launch_f32_variant(const void* x, const void* dy, float* ws, float* dw,
                       const Shape& s, bool vec_dy, bool vec_x, int tile_n,
                       cudaStream_t st) {
  const bool wide = tile_n == 128;
  const bool vec_r = wide ? vec_dy : vec_x, vec_s = wide ? vec_x : vec_dy;
  switch (tile_n) {
    case 16: return launch_f32_r<kIm2col, 16>(x, dy, ws, dw, s, vec_r, vec_s, st);
    case 24: return launch_f32_r<kIm2col, 24>(x, dy, ws, dw, s, vec_r, vec_s, st);
    case 32: return launch_f32_r<kIm2col, 32>(x, dy, ws, dw, s, vec_r, vec_s, st);
    case 64: return launch_f32_r<kIm2col, 64>(x, dy, ws, dw, s, vec_r, vec_s, st);
    case 128: return launch_f32_r<kIm2col, 128>(x, dy, ws, dw, s, vec_r, vec_s, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kF16, bool kIm2col, bool kVecA, bool kVecB, bool kWideO>
int launch_tc(const void* x, const void* dy, float* ws, float* dw,
              const Shape& s, cudaStream_t stream) {
  constexpr int kM = kWideO ? 128 : 64;
  const int m_rows = kIm2col ? s.mt : s.ci;
  const int64_t gz = kIm2col ? (int64_t)s.splits
                             : (int64_t)s.kh * s.kw * s.splits;
  const int64_t gy = (int64_t)(s.co + kM - 1) / kM * s.groups;
  if (gz > 65535 || gy > 65535 || s.chunk % tc::kBK != 0)
    return cudaErrorInvalidConfiguration;
  auto kernel = tc::conv_dw_wgmma_kernel<kF16, kIm2col, kVecA, kVecB, kWideO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((m_rows + tc::kBN - 1) / tc::kBN, (unsigned)gy, (unsigned)gz);
  kernel<<<grid, tc::kThreads, tc::kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
      s.splits == 1 ? dw : ws, s,
      Step{tc::kBK / s.ow, tc::kBK % s.ow});
  err = cudaGetLastError();
  if (err != cudaSuccess || s.splits == 1) return err;
  return launch_reduce(ws, dw, s, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kF16, bool kIm2col, bool kVecA, bool kVecB>
int launch_tc_o(const void* x, const void* dy, float* ws, float* dw,
                const Shape& s, bool wide_o, cudaStream_t stream) {
  return wide_o
      ? launch_tc<kF16, kIm2col, kVecA, kVecB, true>(x, dy, ws, dw, s, stream)
      : launch_tc<kF16, kIm2col, kVecA, kVecB, false>(x, dy, ws, dw, s, stream);
}

template <bool kF16, bool kIm2col>
int launch_tc_variant(const void* x, const void* dy, float* ws, float* dw,
                      const Shape& s, bool vec_dy, bool vec_x, bool wide_o,
                      cudaStream_t st) {
  if (vec_dy && vec_x)
    return launch_tc_o<kF16, kIm2col, true, true>(x, dy, ws, dw, s, wide_o, st);
  if (vec_dy)
    return launch_tc_o<kF16, kIm2col, true, false>(x, dy, ws, dw, s, wide_o, st);
  if (vec_x)
    return launch_tc_o<kF16, kIm2col, false, true>(x, dy, ws, dw, s, wide_o, st);
  return launch_tc_o<kF16, kIm2col, false, false>(x, dy, ws, dw, s, wide_o, st);
}

// variant: bit 0 reads dy and bit 1 reads x by 16-byte loads; then, for
// bf16 and float16, bit 2 takes tiles of 64 output channels (O/G <= 64)
// instead of 128, and for float32, bits 2-6 hold the S operand's rows / 8
// (16, 24, 32 or 64 when O/G is at most that, else 128).  ci and co are
// the whole widths I and O, each a multiple of groups; the loads and tiles
// are chosen by a group's widths I/G and O/G.
template <bool kIm2col>
int dispatch(const void* x, const void* dy, void* ws, void* dw, int n, int h,
             int w, int ci, int oh, int ow, int co, int kh, int kw, int sy,
             int sx, int py, int px, int dil_h, int dil_w, int groups,
             int splits, int chunk, int dtype, int variant, void* stream) {
  // a tap's offsets must fit the 16-bit halves of the tensor-core kernel
  if (n <= 0 || h <= 0 || w <= 0 || ci <= 0 || oh <= 0 || ow <= 0 || co <= 0 ||
      kh <= 0 || kw <= 0 || sy <= 0 || sx <= 0 || splits <= 0 || chunk <= 0 ||
      dil_h <= 0 || dil_w <= 0 || (int64_t)(kh - 1) * dil_h > 8192 ||
      (int64_t)(kw - 1) * dil_w > 8192 || py > 8192 || px > 8192 ||
      (int64_t)splits * chunk < (int64_t)n * oh * ow || variant < 0 ||
      variant > (dtype == 0 ? 127 : 7) || groups <= 0 || ci % groups != 0 ||
      co % groups != 0)
    return cudaErrorInvalidValue;
  const int cg = ci / groups, og = co / groups;
  Shape s{n, h, w, cg, oh, ow, og, kh, kw, sy, sx, py, px, dil_h, dil_w,
          kh * kw * cg, splits, chunk, groups, ci, co};
  auto st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* dwf = static_cast<float*>(dw);
  const bool vec_dy = variant & 1, vec_x = variant & 2;
  if (dtype == 0) {
    const int tile_n = (variant >> 2) * 8;
    // a group's slice keeps 16-byte alignment only where its width does
    if ((vec_dy && (og % 4 != 0 || !aligned16(dy))) ||
        (vec_x && (cg % 4 != 0 || !aligned16(x))))
      return cudaErrorMisalignedAddress;
    if (tile_n != 128 && og > tile_n) return cudaErrorInvalidValue;
    return launch_f32_variant<kIm2col>(x, dy, wsf, dwf, s, vec_dy, vec_x,
                                       tile_n, st);
  }
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  const bool wide_o = !(variant & 4);
  if ((vec_dy && (og % 8 != 0 || !aligned16(dy))) ||
      (vec_x && (cg % 8 != 0 || !aligned16(x))))
    return cudaErrorMisalignedAddress;
  if (!wide_o && og > 64) return cudaErrorInvalidValue;
  if (dtype == 2)
    return launch_tc_variant<true, kIm2col>(x, dy, wsf, dwf, s, vec_dy, vec_x,
                                            wide_o, st);
  return launch_tc_variant<false, kIm2col>(x, dy, wsf, dwf, s, vec_dy, vec_x,
                                           wide_o, st);
}

}  // namespace

// x (N, H, W, I) and dy (N, OH, OW, O) contiguous, of one dtype (0 float32,
// 1 bf16, 2 float16), in `groups` groups; ws float32
// [splits][O][KH*KW*I/G] (unused with one split); dw float32 (O, KH, KW,
// I/G); variant as dispatch() says.
extern "C" int mxt_conv_dw_pertap(const void* x, const void* dy, void* ws,
                                  void* dw, int n, int h, int w, int ci,
                                  int oh, int ow, int co, int kh, int kw,
                                  int sy, int sx, int py, int px, int dil_h,
                                  int dil_w, int groups, int splits, int chunk,
                                  int dtype, int variant, void* stream) {
  return dispatch<false>(x, dy, ws, dw, n, h, w, ci, oh, ow, co, kh, kw, sy, sx,
                      py, px, dil_h, dil_w, groups, splits, chunk, dtype,
                      variant, stream);
}

extern "C" int mxt_conv_dw_im2col(const void* x, const void* dy, void* ws,
                                  void* dw, int n, int h, int w, int ci,
                                  int oh, int ow, int co, int kh, int kw,
                                  int sy, int sx, int py, int px, int dil_h,
                                  int dil_w, int groups, int splits, int chunk,
                                  int dtype, int variant, void* stream) {
  return dispatch<true>(x, dy, ws, dw, n, h, w, ci, oh, ow, co, kh, kw, sy, sx,
                      py, px, dil_h, dil_w, groups, splits, chunk, dtype,
                      variant, stream);
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
