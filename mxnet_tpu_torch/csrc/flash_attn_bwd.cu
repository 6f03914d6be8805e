// Flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces mxnet_tpu/ops/attention.py::_bwd_dq_kernel (K4a) and
// ::_bwd_dkv_kernel (K4b), the Pallas TPU kernels behind _bwd_pallas.  They
// compute the same functions, from the forward's lse and
// delta = rowsum(dO * O) (both float32, per query row):
//   s  = Q K^T * sm_scale              [causal: masked where col > row]
//   p  = exp(s - lse)                  (0 where masked)
//   dp = dO V^T,  ds = p * (dp - delta) * sm_scale
//   K4a: dQ = ds K            K4b: dV = p^T dO,  dK = ds^T Q
// with float32 sums whatever the input type, and dQ, dK, dV written in the
// input type.  The causal mask is top-left aligned on absolute indices
// (col > row), also when Sq != Sk.
//
// One thread block owns one output tile and walks the other axis itself,
// with the accumulator in registers (the Pallas grids carry it across a
// sequential grid axis), so every output element is written by exactly one
// block: no atomics, and the gradients are the same bit for bit from run to
// run.  That keeps the two-kernel split: K4a recomputes S and dP over
// q-tiles, K4b over k-tiles.
//  - K4a: one block per (64-row q-tile, batch*head).  Q and dO stay in
//    shared memory; the block walks the K/V tiles, up to the diagonal when
//    causal, the longest q-tiles first.
//  - K4b: one block per (64-row k-tile, batch*head).  K and V stay; the
//    block walks the Q/dO tiles from the first one that reaches the
//    diagonal.  Its scores are computed transposed (keys down, queries
//    across), S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out
//    of the products in the accumulator layout of the rows of dV and dK the
//    thread owns, and feed dV += P^T dO and dK += dS^T Q from registers.
//
// Routes (ops/attention.py bwd_launch_plan names the same for each head
// dim and type).  The kernels are instantiated for the head-dim buckets DB
// in {32, 64, 128, 256} and take the runtime head dim d <= DB: columns
// d..DB are loaded as zeros (they add exactly 0) and never stored.
//  - "wgmma": bf16 and float16 at DB <= 128, on the tensor cores.  One
//    warpgroup of 128 threads; S and dP (K4a), S^T and dP^T (K4b) are
//    wgmma.mma_async m64nNk16 with both operands in shared memory, K-major;
//    their float32 accumulators become P and dS in registers, are rounded
//    to the input type (as FA2/FA3 round P, and the forward's plain
//    version rounds it before P V) and feed the second products as wgmma's
//    A operand from registers: the accumulator layout of two n8 column
//    blocks is the A fragment of one k16 step.  The B operand of a second
//    product (K in dS K; dO and Q in P^T dO and dS^T Q) is MN-major, read
//    through the 16-bit types' transpose flag from the same tile that the
//    first product reads K-major: a tile is [DB/64 atoms][rows][64] with
//    128-byte swizzled rows (16-byte chunk c of row r at c ^ (r & 7)),
//    which is both the K-major layout of (rows, d) and the MN-major layout
//    of (d, rows).  No P or dS tile goes through shared memory.  At DB = 32
//    the tiles keep 64 columns (the 128-byte swizzle), the upper 32 zero.
//  - "tf32x3": float32 at DB <= 128, on the tensor cores with float32
//    accuracy: each operand x is split into hi, x rounded to tf32 (to
//    nearest, ties away), and lo = x - hi, and each product is lo*hi +
//    hi*lo + hi*hi into float32 accumulators (what the lo*lo term and the
//    tf32 reading of lo drop is below 2^-20 of a product).  Four warps,
//    each owning 16 rows, run
//    mma.sync.m16n8k8.tf32 (PyTorch's memory-efficient attention takes
//    the same route, CUTLASS's OpMultiplyAddFastF32 on m16n8k8) on the same
//    tiling as the wgmma route.  Not tf32 wgmma: it takes a shared-memory
//    operand K-major only (the transpose flag exists for 16-bit types
//    only), so K4a's K and K4b's dO and Q would need transposed copies,
//    and the hi/lo split doubles every tile, past the shared memory that
//    keeps several blocks on an SM.  mma.sync reads its fragments from float32
//    tiles padded to rows of DB + 4 floats in any layout without bank
//    conflicts, and splits them in registers; P and dS, also split, feed
//    the second products from registers: the C fragment of an n8 block is
//    the A fragment of one k8 step with its k indices permuted (logical k
//    t and t + 4 are columns 2t and 2t + 1), the B rows read in the same
//    order.
//  - "cuda_cores": every type at DB = 256, the design of the first port.
//    With a 64-row warpgroup tile, K4b's dK and dV accumulators alone
//    would take 256 registers a thread at DB = 256, and K4a's 128 beside
//    the scores', so that bucket keeps the CUDA-core kernels: 256 threads
//    as a 16 x 16 grid, float32 tiles of 32 x 32 rows padded by one float.
// The tensor-core kernels fill a ring of two stages by cp.async (16-byte
// copies where d is a multiple of a 16-byte chunk and the rows are
// aligned, else element by element through registers): the next tile
// loads while the block computes on the current one.  A block's products,
// its exponentials and its second products wait on each other in turn;
// the blocks on an SM (three or four) overlap them.  No branch encloses
// a wgmma (ptxas would serialize them, its warning C7518); the ragged edge
// and the causal mask are selects on the scores.
// The tile layouts, the loaders, the tf32 split and the mma.sync and
// wgmma wrappers are shared with the forward kernel (attn_tc.cuh).
//
// The ragged edge is masked here: rows past Sq and columns past Sk are
// loaded as zeros, get p = 0 (a zero-padded key has s = 0 and would
// otherwise get p = exp(-lse) != 0), and are never written.  So every shape
// runs the kernels; nothing falls back.
//
// Bound on the H100.  At the training shape (B=8, H=8, S=1024, D=64,
// causal) there are 33.6 M unmasked (row, col) pairs.  K4a does 6*D flops
// per pair (s, dp, dQ): 12.9 GFLOP; K4b 8*D (s, dV, dp, dK): 17.2 GFLOP,
// against about 84 MB of traffic for each kernel (0.025 ms at 3.35 TB/s).
// float32-accurate work on the tensor cores runs at most at 495 / 3 = 165
// TFLOP/s: 0.078 and 0.104 ms; bf16 and f16 at 989 TFLOP/s: 0.013 and
// 0.017 ms.  All are bound by operations.  On an H100 at 700 W the
// kernels take about 21 % of these bounds in float32 and 15 % in bf16 and
// float16 (PERF.md): in float32 the first two products with their hi/lo
// splits take 72 % of the time, in bf16 the second products 6 %.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tc.cuh"

namespace {

// ------------------------------------------------ the tensor cores

namespace tc {

constexpr int kThreads = 128;  // one warpgroup: four warps of 16 rows
constexpr int kRows = 64;      // rows of the block's own tile
// slots of the cp.async ring: 3 or 4 were no faster (attn_bwd_probe.py),
// so the loads are not what holds the kernels back
constexpr int kStages = 2;

// ---- the wgmma route: bf16 (kF16 false) and float16

template <int DB, bool kF16>
struct Wgmma {
  using T = std::conditional_t<kF16, __half, __nv_bfloat16>;
  using U = uint16_t;
  using L = Swizzled<DB>;
  static constexpr int kCols = L::kCols;  // accumulator columns along d
  // the rows a step walks: K4a 64 keys; K4b 64 queries, or 32 at DB = 128,
  // where its dK and dV accumulators take 128 registers a thread
  static constexpr int kDqStep = 64;
  static constexpr int kDkvStep = DB > 64 ? 32 : 64;

  // acc[64 x N] += A B^T over DB columns: A the 64 rows of tile a, B the N
  // rows of tile b, both K-major; a k16 step is 32 bytes into a row, and
  // every 4 steps the next atom
  template <int N>
  __device__ static void nt(float (&acc)[N / 2], const uint8_t* a, const uint8_t* b) {
    const uint32_t sa = smem_u32(a), sb = smem_u32(b);
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk)
      wgmma_ss<kF16>(acc, wgmma_desc(sa + (kk >> 2) * (kRows * 128) + (kk & 3) * 32, 16, 1024),
                     wgmma_desc(sb + (kk >> 2) * (N * 128) + (kk & 3) * 32, 16, 1024));
  }

  // S = Q K^T and dP = dO V^T (or their transposes), issued together
  template <int N>
  __device__ static void nt2(float (&s)[N / 2], const uint8_t* a1, const uint8_t* b1,
                             float (&t)[N / 2], const uint8_t* a2, const uint8_t* b2) {
    wgmma_fence();
    nt<N>(s, a1, b1);
    nt<N>(t, a2, b2);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(t);
  }

  // acc[64 x kCols] += A B: A from registers (KB deep), B the KB rows of
  // tile b read MN-major, one 64-column atom per wgmma (LBO: the next
  // atom; SBO: the next 8 rows; a k16 step is 16 rows)
  template <int KB>
  __device__ static void nn(float (&acc)[kCols / 2], const uint32_t (&a)[KB / 16][4],
                            const uint8_t* b) {
    const uint32_t sb = smem_u32(b);
#pragma unroll
    for (int h = 0; h < kCols / 64; ++h)
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        wgmma_rs<kF16>(*reinterpret_cast<float(*)[32]>(acc + 32 * h), a[kk],
                       wgmma_desc(sb + h * (KB * 128) + kk * 2048, KB * 128, 1024));
  }

  template <int KB>
  __device__ static void pv(float (&acc)[kCols / 2], const float (&p)[KB / 2], const uint8_t* b) {
    uint32_t a[KB / 16][4];
    pack_a16<kF16, KB>(a, p);
    wgmma_fence();
    nn<KB>(acc, a, b);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

  template <int KB>
  __device__ static void pv2(float (&acc1)[kCols / 2], const float (&p1)[KB / 2], const uint8_t* b1,
                             float (&acc2)[kCols / 2], const float (&p2)[KB / 2], const uint8_t* b2) {
    uint32_t a1[KB / 16][4], a2[KB / 16][4];
    pack_a16<kF16, KB>(a1, p1);
    pack_a16<kF16, KB>(a2, p2);
    wgmma_fence();
    nn<KB>(acc1, a1, b1);
    nn<KB>(acc2, a2, b2);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc1);
    fence_acc(acc2);
  }
};

// ---- the tf32x3 route: float32

template <int DB>
struct Tf32x3 {
  using T = float;
  using U = uint32_t;
  using L = Padded<DB>;
  static constexpr int kCols = DB;
  static constexpr int kLd = L::kLd;
  // 32 rows a step in both kernels: at DB = 64 a block then takes 70 KB of
  // shared memory and three fit on an SM (64-row steps, 105 KB and two
  // blocks an SM, took 6 % longer at the training shape)
  static constexpr int kDqStep = 32;
  static constexpr int kDkvStep = 32;

  // acc[64 x N] += A B^T over DB columns, the warp's 16 rows of tile a
  // against the N rows of tile b (fragments: rows g, g + 8 of A and
  // columns t, t + 4 of a k8 step; B row 8j + g)
  template <int N>
  __device__ static void nt(float (&acc)[N / 2], const uint8_t* a, const uint8_t* b) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
    const float* A = reinterpret_cast<const float*>(a) + (warp * 16 + g) * kLd + t;
    const float* B = reinterpret_cast<const float*>(b) + g * kLd + t;
#pragma unroll
    for (int kk = 0; kk < DB / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(A[kk * 8], ah[0], al[0]);
      split_tf32(A[8 * kLd + kk * 8], ah[1], al[1]);
      split_tf32(A[kk * 8 + 4], ah[2], al[2]);
      split_tf32(A[8 * kLd + kk * 8 + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        mma_3xtf32(acc + 4 * j, ah, al, B[j * 8 * kLd + kk * 8], B[j * 8 * kLd + kk * 8 + 4]);
    }
  }

  template <int N>
  __device__ static void nt2(float (&s)[N / 2], const uint8_t* a1, const uint8_t* b1,
                             float (&t)[N / 2], const uint8_t* a2, const uint8_t* b2) {
    nt<N>(s, a1, b1);
    nt<N>(t, a2, b2);
  }

  // acc[64 x DB] += P B: P (KB deep) in the accumulator layout, B the KB
  // rows of tile b.  k8 step c takes P's n8 block c with logical k t and
  // t + 4 standing for columns 2t and 2t + 1, so B's rows are read in the
  // same order: 8c + 2t and 8c + 2t + 1
  template <int KB>
  __device__ static void pv(float (&acc)[kCols / 2], const float (&p)[KB / 2], const uint8_t* b) {
    const int g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
    const float* B = reinterpret_cast<const float*>(b) + 2 * t * kLd + g;
#pragma unroll
    for (int c = 0; c < KB / 8; ++c) {
      uint32_t ah[4], al[4];
      split_tf32(p[4 * c], ah[0], al[0]);
      split_tf32(p[4 * c + 2], ah[1], al[1]);
      split_tf32(p[4 * c + 1], ah[2], al[2]);
      split_tf32(p[4 * c + 3], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
        mma_3xtf32(acc + 4 * j, ah, al, B[8 * c * kLd + 8 * j], B[(8 * c + 1) * kLd + 8 * j]);
    }
  }

  template <int KB>
  __device__ static void pv2(float (&acc1)[kCols / 2], const float (&p1)[KB / 2], const uint8_t* b1,
                             float (&acc2)[kCols / 2], const float (&p2)[KB / 2], const uint8_t* b2) {
    pv<KB>(acc1, p1, b1);
    pv<KB>(acc2, p2, b2);
  }
};

// dynamic shared memory: K4a holds Q and dO and a ring of kStages (K,
// V) stages; K4b K and V and a ring of (Q, dO, lse, delta) stages; plus
// 1024 bytes to align the tiles
template <class R, int BK>
constexpr int dq_smem() {
  return 2 * R::L::template bytes<kRows>() + 2 * kStages * R::L::template bytes<BK>() +
         1024;
}
template <class R, int BQ>
constexpr int dkv_smem() {
  return 2 * R::L::template bytes<kRows>() + 2 * kStages * R::L::template bytes<BQ>() +
         8 * kStages * BQ + 1024;
}

// K4a: dQ for one (64-row q-tile, batch*head); BK keys a step.  Thread
// (warp w, lane 4g + t) holds rows 16w + g (+8) and, of each n8 column
// block j, columns 8j + 2t (+1) of every product.
template <class R, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const typename R::U* __restrict__ q,
                       const typename R::U* __restrict__ k,
                       const typename R::U* __restrict__ v,
                       const typename R::U* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       typename R::T* __restrict__ dq, int sq, int sk, int d,
                       int num_q, float sm_scale, int causal, int vec) {
  using L = typename R::L;
  constexpr int TQ = L::template bytes<kRows>();
  constexpr int TK = L::template bytes<BK>();
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sQ = aligned_smem(smem_raw);
  uint8_t* const sO = sQ + TQ;
  uint8_t* const ring = sO + TQ;  // slot s: K at ring + 2 s TK, then V

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  // the longest causal rows first: q-tiles run from the last to the first
  const int qt = num_q - 1 - (int)(blockIdx.x % num_q);
  const int64_t bh = blockIdx.x / num_q;
  const int q0 = qt * kRows;
  const int q_last = min(q0 + kRows, sq) - 1;
  // causal: K tiles that start past the tile's last row are wholly masked
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int nk = (k_end + BK - 1) / BK;
  const typename R::U* kb = k + bh * sk * d;
  const typename R::U* vb = v + bh * sk * d;

  // K and V tiles j into slot j % S
  auto load_stage = [&](int j) {
    uint8_t* st = ring + (j % S) * 2 * TK;
    load_tile<L, BK, kThreads>(st, kb, j * BK, sk, d, vec);
    load_tile<L, BK, kThreads>(st + TK, vb, j * BK, sk, d, vec);
  };
  load_tile<L, kRows, kThreads>(sQ, q + bh * sq * d, q0, sq, d, vec);
  load_tile<L, kRows, kThreads>(sO, dout + bh * sq * d, q0, sq, d, vec);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < nk) load_stage(j);
    cp_async_commit();
  }

  int row[2];
  float row_lse[2], row_delta[2];  // lse and delta in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    row_lse[h] = row[h] < sq ? lse[bh * sq + row[h]] * kLog2e : 0.f;
    row_delta[h] = row[h] < sq ? delta[bh * sq + row[h]] : 0.f;
  }
  const float scale_log2 = sm_scale * kLog2e;

  float acc[R::kCols / 2];
#pragma unroll
  for (int i = 0; i < R::kCols / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < nk; ++j) {
    // into the slot of stage j - 1, which every thread has finished with
    if (j + S - 1 < nk) load_stage(j + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();  // stage j (and Q, dO) has landed
    fence_proxy_async();
    __syncthreads();
    const uint8_t* sK = ring + (j % S) * 2 * TK;
    const uint8_t* sV = sK + TK;

    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    R::template nt2<BK>(s, sQ, sK, dp, sO, sV);

    const int k0 = j * BK;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const int col = k0 + 8 * jj + 2 * t + e;
          const bool ok = row[h] < sq && col < sk && !(causal && col > row[h]);
          // masked, or past the ragged edge: p = 0
          const float p = ok ? exp2f(fmaf(s[i], scale_log2, -row_lse[h])) : 0.f;
          dp[i] = p * (dp[i] - row_delta[h]) * sm_scale;
        }
    R::template pv<BK>(acc, dp, sK);  // dQ += dS K
    __syncthreads();  // the stage is consumed before the next load into it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    typename R::T* out = dq + (bh * sq + row[h]) * d;
#pragma unroll
    for (int jj = 0; jj < R::kCols / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * t + e;
        if (col < d) store(out + col, acc[4 * jj + 2 * h + e]);
      }
  }
}

// K4b: dK and dV for one (64-row k-tile, batch*head); BQ queries a step.
// The products are transposed: thread (warp w, lane 4g + t) holds keys
// 16w + g (+8) and, of each n8 block j, queries 8j + 2t (+1).
template <class R, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const typename R::U* __restrict__ q,
                        const typename R::U* __restrict__ k,
                        const typename R::U* __restrict__ v,
                        const typename R::U* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        typename R::T* __restrict__ dk, typename R::T* __restrict__ dv,
                        int sq, int sk, int d, int num_k, float sm_scale, int causal,
                        int vec) {
  using L = typename R::L;
  constexpr int TK = L::template bytes<kRows>();
  constexpr int TQ = L::template bytes<BQ>();
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sK = aligned_smem(smem_raw);
  uint8_t* const sV = sK + TK;
  uint8_t* const ring = sV + TK;  // slot s: Q at ring + 2 s TQ, then dO
  // slot s: lse and delta of its BQ query rows
  float* const scalars = reinterpret_cast<float*>(ring + 2 * S * TQ);

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  // k-tiles in ascending order: when causal the first ones walk the most
  // q-tiles, so the longest blocks start first
  const int kt = (int)(blockIdx.x % num_k);
  const int64_t bh = blockIdx.x / num_k;
  const int k0 = kt * kRows;
  // causal: query rows before k0 see no column of this tile
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int nq = q_begin < sq ? (sq - q_begin + BQ - 1) / BQ : 0;
  const typename R::U* qb = q + bh * sq * d;
  const typename R::U* ob = dout + bh * sq * d;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  load_tile<L, kRows, kThreads>(sK, k + bh * sk * d, k0, sk, d, vec);
  load_tile<L, kRows, kThreads>(sV, v + bh * sk * d, k0, sk, d, vec);
  // Q, dO, lse and delta tiles i into slot i % S
  auto load_stage = [&](int i) {
    const int s = i % S, r0 = q_begin + i * BQ;
    load_tile<L, BQ, kThreads>(ring + 2 * s * TQ, qb, r0, sq, d, vec);
    load_tile<L, BQ, kThreads>(ring + (2 * s + 1) * TQ, ob, r0, sq, d, vec);
    load_row_scalars<BQ, kThreads>(scalars + 2 * s * BQ, lb, r0, sq);
    load_row_scalars<BQ, kThreads>(scalars + (2 * s + 1) * BQ, db, r0, sq);
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nq) load_stage(i);
    cp_async_commit();
  }

  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + warp * 16 + g + 8 * h;
  const float scale_log2 = sm_scale * kLog2e;

  float dk_acc[R::kCols / 2], dv_acc[R::kCols / 2];
#pragma unroll
  for (int i = 0; i < R::kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

#pragma unroll 1
  for (int i = 0; i < nq; ++i) {
    // into the slot of stage i - 1, which every thread has finished with
    if (i + S - 1 < nq) load_stage(i + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();  // stage i (and K, V) has landed
    fence_proxy_async();
    __syncthreads();
    const int s_ = i % S;
    const uint8_t* sQ = ring + 2 * s_ * TQ;
    const uint8_t* sO = sQ + TQ;
    const float* sL = scalars + 2 * s_ * BQ;
    const float* sD = sL + BQ;

    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int n = 0; n < BQ / 2; ++n) s[n] = dp[n] = 0.f;
    R::template nt2<BQ>(s, sK, sQ, dp, sV, sO);  // S^T = K Q^T, dP^T = V dO^T

    const int q0 = q_begin + i * BQ;
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + 2 * t + e;  // this thread's query column
        const int qrow = q0 + c;
        const float l2 = sL[c] * kLog2e, dl = sD[c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 4 * jj + 2 * h + e;
          const bool ok = qrow < sq && key[h] < sk && !(causal && key[h] > qrow);
          const float p = ok ? exp2f(fmaf(s[n], scale_log2, -l2)) : 0.f;
          dp[n] = p * (dp[n] - dl) * sm_scale;
          s[n] = p;
        }
      }
    R::template pv2<BQ>(dv_acc, s, sO, dk_acc, dp, sQ);  // dV += P^T dO, dK += dS^T Q
    __syncthreads();  // the stage is consumed before the next load into it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= sk) continue;
    typename R::T* dkr = dk + (bh * sk + key[h]) * d;
    typename R::T* dvr = dv + (bh * sk + key[h]) * d;
#pragma unroll
    for (int jj = 0; jj < R::kCols / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * t + e;
        if (col >= d) continue;
        store(dkr + col, dk_acc[4 * jj + 2 * h + e]);
        store(dvr + col, dv_acc[4 * jj + 2 * h + e]);
      }
  }
}

}  // namespace tc

// ------------------------------------------ the CUDA cores: DB = 256

namespace cc {

constexpr int kThreads = 256;

// Rows [r0, r0 + ROWS) and columns [0, D) of a contiguous (rows, d) array
// into dst as float32, with a row stride of D + 1; zeros for rows past
// `rows` and columns past d.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int d) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * LD + c] = gr < rows && c < d ? to_f32(src[(int64_t)gr * d + c]) : 0.f;
  }
}

template <int D, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D, int BQ, int BK>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BK * (BQ + 1) + 2 * BQ);
}

// K4a: dQ for one (q-tile, batch*head).  256 threads as a 16 x 16 grid,
// a (BQ/16) x (BK/16) micro-tile of the score tile per thread; both
// operands of every multiply-add are read from shared memory.
template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int sk, int d, int num_q,
                    float sm_scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;  // padded row of the dS tile
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int RJ = BK / 16;  // key columns per thread
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qt = num_q - 1 - (int)(blockIdx.x % num_q);
  const int64_t bh = blockIdx.x / num_q;
  const int q0 = qt * BQ;
  load_tile<D, BQ>(sQ, q + bh * sq * d, q0, sq, d);
  load_tile<D, BQ>(sdO, dout + bh * sq * d, q0, sq, d);

  float row_lse[RI], row_delta[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < sq ? lse[bh * sq + row] : 0.f;
    row_delta[i] = row < sq ? delta[bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q and dO are loaded; the previous K and dS consumed
    load_tile<D, BK>(sK, kb, k0, sk, d);
    load_tile<D, BK>(sV, vb, k0, sk, d);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RI], ov[RI], kv[RJ], vv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + dd];
        ov[i] = sdO[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + dd];
        vv[j] = sV[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int col = k0 + tx + 16 * j;
        float p = 0.f;  // masked, or past the ragged edge
        if (row < sq && col < sk && !(causal && col > row))
          p = expf(s[i][j] * sm_scale - row_lse[i]);
        sdS[(ty + 16 * i) * LDS + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RI], kv[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = sdS[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* out = dq + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (tx + 16 * c < d) store(out + tx + 16 * c, acc[i][c]);
  }
}

// K4b: dK and dV for one (k-tile, batch*head), the score tile transposed
// (keys down, queries across); one P/dS tile in shared memory takes P,
// then dS.
template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                     int d, int num_k, float sm_scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LDP = BQ + 1;  // padded row of the P^T / dS^T tile
  constexpr int RI = BK / 16;  // key rows per thread
  constexpr int RJ = BQ / 16;  // query columns per thread
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;      // P^T, then dS^T: (key, query)
  float* sLse = sP + BK * LDP;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int kt = (int)(blockIdx.x % num_k);
  const int64_t bh = blockIdx.x / num_k;
  const int k0 = kt * BK;
  load_tile<D, BK>(sK, k + bh * sk * d, k0, sk, d);
  load_tile<D, BK>(sV, v + bh * sk * d, k0, sk, d);

  float dk_acc[RI][DC], dv_acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const T* qb = q + bh * sq * d;
  const T* ob = dout + bh * sq * d;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    __syncthreads();  // K and V are loaded; the previous Q, dO, dS consumed
    load_tile<D, BQ>(sQ, qb, q0, sq, d);
    load_tile<D, BQ>(sdO, ob, q0, sq, d);
    if (tid < BQ) {
      const int row = q0 + tid;
      sLse[tid] = row < sq ? lb[row] : 0.f;
      sDelta[tid] = row < sq ? db[row] : 0.f;
    }
    __syncthreads();

    // transposed scores: key k0 + ty + 16 i, query q0 + tx + 16 j
    float s[RI][RJ], ds[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = ds[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float kv[RI], vv[RI], qv[RJ], ov[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = sK[(ty + 16 * i) * LD + dd];
        vv[i] = sV[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + dd];
        ov[j] = sdO[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          ds[i][j] = fmaf(ov[j], vv[i], ds[i][j]);  // dp for now
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int row = q0 + tx + 16 * j;
        float p = 0.f;  // masked, or past the ragged edge
        if (row < sq && col < sk && !(causal && col > row))
          p = expf(s[i][j] * sm_scale - sLse[tx + 16 * j]);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        ds[i][j] = p * (ds[i][j] - sDelta[tx + 16 * j]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {  // dV += P^T dO
      float pv[RI], ov[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + 16 * i) * LDP + qq];
#pragma unroll
      for (int c = 0; c < DC; ++c) ov[c] = sdO[qq * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dv_acc[i][c] = fmaf(pv[i], ov[c], dv_acc[i][c]);
    }
    __syncthreads();  // P consumed: the tile now takes dS

#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) sP[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {  // dK += dS^T Q
      float dsv[RI], qv[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = sP[(ty + 16 * i) * LDP + qq];
#pragma unroll
      for (int c = 0; c < DC; ++c) qv[c] = sQ[qq * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
    T* dkr = dk + (bh * sk + row) * d;
    T* dvr = dv + (bh * sk + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (tx + 16 * c >= d) continue;
      store(dkr + tx + 16 * c, dk_acc[i][c]);
      store(dvr + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

}  // namespace cc

// ------------------------------------------------------- the launches

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, d;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// the tensor-core route of a type: wgmma for bf16 and float16, 3xTF32 for
// float32
template <int DB, typename T>
struct Route {
  using type = tc::Wgmma<DB, std::is_same<T, __half>::value>;
};
template <int DB>
struct Route<DB, float> {
  using type = tc::Tf32x3<DB>;
};

// the 16-byte copies need d a multiple of a chunk and aligned rows
template <class R>
int vec_loads(const Args& a) {
  const auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return a.d % R::L::kElems == 0 && al(a.q) && al(a.k) && al(a.v) && al(a.dout);
}

template <class R, int BK>
cudaError_t launch_dq_tc(const Args& a) {
  constexpr int smem = tc::dq_smem<R, BK>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = tc::flash_bwd_dq_tc_kernel<R, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using U = typename R::U;
  const int num_q = (a.sq + tc::kRows - 1) / tc::kRows;
  const unsigned grid = (unsigned)((int64_t)num_q * a.bh);
  kern<<<grid, tc::kThreads, smem, a.stream>>>(
      static_cast<const U*>(a.q), static_cast<const U*>(a.k),
      static_cast<const U*>(a.v), static_cast<const U*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<typename R::T*>(a.dq), a.sq, a.sk, a.d, num_q, a.sm_scale,
      a.causal, vec_loads<R>(a));
  return cudaGetLastError();
}

template <class R, int BQ>
cudaError_t launch_dkv_tc(const Args& a) {
  constexpr int smem = tc::dkv_smem<R, BQ>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = tc::flash_bwd_dkv_tc_kernel<R, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using U = typename R::U;
  const int num_k = (a.sk + tc::kRows - 1) / tc::kRows;
  const unsigned grid = (unsigned)((int64_t)num_k * a.bh);
  kern<<<grid, tc::kThreads, smem, a.stream>>>(
      static_cast<const U*>(a.q), static_cast<const U*>(a.k),
      static_cast<const U*>(a.v), static_cast<const U*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<typename R::T*>(a.dk), static_cast<typename R::T*>(a.dv),
      a.sq, a.sk, a.d, num_k, a.sm_scale, a.causal, vec_loads<R>(a));
  return cudaGetLastError();
}

// the CUDA-core kernels at DB = 256: 32 x 32 tiles (64 x 64 would take
// 273 KB of shared memory)
template <bool DQ, typename T>
cudaError_t launch_cc(const Args& a) {
  constexpr int D = 256, B = 32;
  constexpr size_t smem = DQ ? cc::dq_smem_bytes<D, B, B>() : cc::dkv_smem_bytes<D, B, B>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  const int tiles = ((DQ ? a.sq : a.sk) + B - 1) / B;
  const unsigned grid = (unsigned)((int64_t)tiles * a.bh);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if constexpr (DQ) {
    auto kern = cc::flash_bwd_dq_kernel<D, B, B, T>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, cc::kThreads, smem, a.stream>>>(q, k, v, dout, lse, delta,
                                                 static_cast<T*>(a.dq), a.sq, a.sk, a.d,
                                                 tiles, a.sm_scale, a.causal);
  } else {
    auto kern = cc::flash_bwd_dkv_kernel<D, B, B, T>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, cc::kThreads, smem, a.stream>>>(q, k, v, dout, lse, delta,
                                                 static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                 a.sq, a.sk, a.d, tiles, a.sm_scale, a.causal);
  }
  return cudaGetLastError();
}

// one bucket of the tensor-core routes, with its route's steps
template <bool DQ, int DB, typename T>
cudaError_t launch_tc(const Args& a) {
  using R = typename Route<DB, T>::type;
  if constexpr (DQ)
    return launch_dq_tc<R, R::kDqStep>(a);
  else
    return launch_dkv_tc<R, R::kDkvStep>(a);
}

template <bool DQ, typename T>
cudaError_t dispatch_d(const Args& a) {
  // the smallest head-dim bucket that holds d, and its route
  // (ops/attention.py bwd_launch_plan picks the same)
  const int d = a.d;
  if (d >= 1 && d <= 32) return launch_tc<DQ, 32, T>(a);
  if (d > 32 && d <= 64) return launch_tc<DQ, 64, T>(a);
  if (d > 64 && d <= 128) return launch_tc<DQ, 128, T>(a);
  if (d > 128 && d <= 256) return launch_cc<DQ, T>(a);
  return cudaErrorInvalidValue;
}

template <bool DQ>
int dispatch(const Args& a, int dtype) {
  if (dtype == 0) return (int)dispatch_d<DQ, float>(a);
  if (dtype == 1) return (int)dispatch_d<DQ, __nv_bfloat16>(a);
  if (dtype == 2) return (int)dispatch_d<DQ, __half>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, dout, dq: contiguous (bh, sq, d); k, v: (bh, sk, d), all of one type;
// lse, delta: (bh, sq) float32.  dtype 0 is float32, 1 is bfloat16, 2 is
// float16; 1 <= d <= 256.  Returns the launch's cudaError_t.
extern "C" int mxt_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, int bh,
                                     int sq, int sk, int d, float sm_scale,
                                     int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, sq, sk, d,
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dtype);
}

// As above; dk, dv: contiguous (bh, sk, d) of the inputs' type.
extern "C" int mxt_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      int bh, int sq, int sk, int d,
                                      float sm_scale, int causal, int dtype,
                                      void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, sq, sk, d,
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dtype);
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
