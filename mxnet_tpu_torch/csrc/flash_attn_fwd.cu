// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces mxnet_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// behind _fwd_pallas).  It computes the same function:
//   O = softmax(Q K^T * sm_scale [causal: -1e30 where col > row]) V
//   lse = m + log(l)                        (per row, float32, natural log)
// with scores, the online softmax and both sums in float32 whatever the
// input type, O written in the input type, l == 0 taken as 1, and K tiles
// wholly above the diagonal skipped in the causal case.  The causal mask
// is top-left aligned on absolute indices (col > row), also when Sq != Sk.
//
// One thread block owns one (q-tile, batch*head) pair and walks the K/V
// tiles itself, up to the diagonal when causal, with O, the row maxima m
// and the row sums l in registers (the Pallas grid carries them across a
// sequential grid axis in VMEM scratch).  Every output element is written
// by one block: no atomics, and O and lse are the same bit for bit from
// launch to launch.  The longest causal q-tiles start first: the last
// q-tile of every head, then the one before it.
//
// Routes (ops/attention.py fwd_launch_plan names the same for each head
// dim and type).  The kernels are instantiated for the head-dim buckets DB
// in {32, 64, 128, 256} and take the runtime head dim d <= DB: columns
// d..DB are loaded as zeros (they add exactly 0) and never stored.
//  - "wgmma": bf16 and float16 at DB <= 128.  A 128-row q-tile owned by
//    two warpgroups of 64 rows (256 threads); 64 keys a step, a ring of
//    four (K, V) stages (a step reads K of its own stage and V of the
//    one before while the next two load).  S = Q K^T
//    by wgmma m64n64k16 with both operands K-major in 128-byte swizzled
//    shared tiles ([DB/64 atoms][rows][64], 16-byte chunk c of row r at
//    c ^ (r & 7); at DB = 32 the upper 32 columns are zero).  The online
//    softmax runs on the accumulator layout in registers: thread (warp w,
//    lane 4g + t) holds rows 16w + g (+8) and, of each n8 column block j,
//    columns 8j + 2t (+1); a row's maximum is reduced over the four
//    threads of a quad by shuffles, its sum only once at the end.  The
//    scale is folded into exp2 (sm_scale * log2 e), and lse converted back
//    to the natural log.  P is rounded to the input type (the rounding
//    point of the plain version) and feeds O += P V as wgmma's A operand
//    from registers: the accumulator of two n8 blocks is the A fragment of
//    one k16 step.  V is the MN-major B operand, read through the
//    transpose flag from the same tile layout.  No P tile goes through
//    shared memory.
//  - "tf32x3": float32 at DB <= 128, on the tensor cores with float32
//    accuracy: x = hi + lo, hi rounded to tf32 (to nearest, ties away), lo
//    = x - hi, each product lo*hi + hi*lo + hi*hi into float32 (what the
//    lo*lo term and the tf32 reading of lo drop is below 2^-20 of a
//    product).  Nothing is split twice: Q once a block and each K and V
//    tile once a stage, by a cooperative pass that rewrites the tile as
//    hi in place and writes lo beside it, so the products read ready
//    operands; P is split in registers and reused as the A fragment (the
//    C fragment of an n8 block is the A fragment of one k8 step with
//    logical k t and t + 4 standing for columns 2t and 2t + 1).
//    At DB <= 64 (Tf32x3Wgmma) the wgmma route's tiling on tf32 wgmma
//    m64nNk8 for both products, float32 tiles in 128-byte swizzled atoms
//    of 32 columns; tf32 has no transpose flag, so the pass writes V
//    transposed with the keys of each 8 in the order of P's logical k.
//    A block takes 209 KB of shared memory at DB = 64 (one an SM).
//    At DB = 128 that would not fit, so (Tf32x3) mma.sync m16n8k8: a
//    64-row q-tile of four warps of 16 rows (128 threads), 32 keys a
//    step, float32 tiles padded to rows of DB + 4 floats (fragment reads
//    in 32 distinct banks), V's rows read in P's logical k order.
//  - "cuda_cores": every type at DB = 256, the design of the first port:
//    a wgmma 64-row tile would hold O's 128 float32 accumulators a thread
//    beside S's 32 and P's 16 fragments and the row state, past what
//    ptxas keeps in 255 registers.  256 threads as a 16 x 16 grid over
//    64 x 64 float32 tiles, rows padded by one float.
// K and V arrive through a ring filled by cp.async (16-byte copies where d
// is a multiple of a 16-byte chunk and the rows are aligned, else element
// by element through registers): the next tile loads while the block
// computes on the current one.  On the wgmma routes a step issues
// S_j = Q K_j^T and O += P_{j-1} V_{j-1} together, so that the softmax of
// S_j runs while the second product is on the tensor cores; O is rescaled
// when it is done.  No branch encloses a wgmma (ptxas would serialize
// them, its warning C7518): the first step's S and the last step's P V
// are peeled out of the loop, and the causal mask and the ragged edge
// are selects on the scores.
//
// The ragged edge is masked here: rows past Sq are computed on zeros and
// never written; columns past Sk get a score of -inf and so p = 0 exactly
// (a zero-padded key has s = 0 and would otherwise count).  So every shape
// runs the kernel; nothing falls back.
//
// Bound on the H100.  At the serving and training shape (B=8, H=8,
// S=1024, D=64, causal) the two products take 4 * B*H * D * S(S+1)/2 =
// 8.6 GFLOP, against 34 MB of q/k/v/o traffic in float32 (0.010 ms at
// 3.35 TB/s).  float32-accurate work on the tensor cores runs at most at
// 495 / 3 = 165 TFLOP/s: 0.052 ms, bound by operations; bf16 and float16
// at 989 TFLOP/s take 0.009 ms of operations against 0.010 ms of bytes.
// Measured times and the designs compared (attn_fwd_probe.py): PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the JAX kernel's mask value
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------ the tensor cores

namespace tc {

// ---- the pieces every tensor-core kernel shares

// the block's q-tile and head: the last q-tile of every head first, then
// the one before it, so that no long causal block starts late
__device__ __forceinline__ void block_tile(int num_q, int& qt, int64_t& bh) {
  const int nbh = gridDim.x / num_q;
  qt = num_q - 1 - (int)(blockIdx.x / nbh);
  bh = blockIdx.x % nbh;
}

// the online softmax of one step on the accumulator layout of its scores
// s (thread: rows row[0], row[1]; of each n8 block jj, columns 8jj + 2t
// (+1) from k0): the scores in log2 units, masked -1e30, past the ragged
// edge -inf (only a step past the diagonal of the warp's rows, from row0,
// or past the edge masks: a branch uniform in the warp, enclosing no
// wgmma); the new row maxima m (reduced over the quad), the factor corr
// that rescales what came before, p = exp2(s - m) in place, and this
// thread's share of the row sums l
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], const int (&row)[2], int row0,
                                               int k0, int t, int sk, int causal,
                                               float scale_log2) {
  if (k0 + BK > sk || (causal && k0 + BK - 1 > row0)) {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const int col = k0 + 8 * jj + 2 * t + e;
          const float x = s[i] * scale_log2;
          s[i] = col >= sk ? -INFINITY : (causal && col > row[h] ? kNegInf : x);
        }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i >> 1) & 1];
}

// O = acc / l in the output type and lse = m ln 2 + log l, for the rows
// below sq and the columns below d (l summed over the quad first; l == 0
// taken as 1)
template <int N, typename T>
__device__ __forceinline__ void write_out(const float (&acc)[N], const float (&m)[2],
                                          float (&l)[2], const int (&row)[2], int t, int sq,
                                          int d, int64_t bh, T* __restrict__ o,
                                          float* __restrict__ lse) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    const float li = l[h] == 0.f ? 1.f : l[h];  // fully-masked rows
    T* out = o + (bh * sq + row[h]) * d;
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + 2 * t + e;
        if (col < d) store(out + col, acc[4 * jj + 2 * h + e] / li);
      }
    if (t == 0) lse[bh * sq + row[h]] = m[h] * kLn2 + logf(li);
  }
}

// ---- the wgmma route: bf16 (kF16 false) and float16

template <int DB, bool kF16>
struct Wgmma {
  using T = std::conditional_t<kF16, __half, __nv_bfloat16>;
  using U = uint16_t;
  using L = Swizzled<DB>;
  static constexpr int kCols = L::kCols;  // accumulator columns along d
  static constexpr int kRoute = 1;        // mxt_flash_attn_fwd_plan's code
  static constexpr int kQRows = 128;      // two warpgroups of 64 rows
  static constexpr int kThreads = 256;
  static constexpr int kStep = 64;        // keys a step
  // slots of the K/V ring: step j reads K of stage j and V of stage j - 1
  // while the stages up to j + kPrefetch load
  static constexpr int kStages = 4;
  static constexpr int kPrefetch = kStages - 2;
  static_assert(kStages >= 3, "the ring holds stages j - 1, j and j + 1");
  static constexpr bool kSplit = false;   // tiles are used as loaded
  static constexpr int kTile = L::template bytes<kStep>();
  static constexpr int kQBytes = L::template bytes<kQRows>();
  static constexpr int kRingBytes = kStages * 2 * kTile;
  static constexpr int kSmem = kQBytes + kRingBytes + 1024;  // and 1 KB to align
  using A = uint32_t[kStep / 16][4];  // P as the A operand

  // K and V tiles of stage j into slot j % kStages
  template <typename Src>
  __device__ static void load(uint8_t* ring, int j, Src kb, Src vb, int sk, int d, bool vec) {
    uint8_t* st = ring + (j % kStages) * 2 * kTile;
    load_tile<L, kStep, kThreads>(st, kb, j * kStep, sk, d, vec);
    load_tile<L, kStep, kThreads>(st + kTile, vb, j * kStep, sk, d, vec);
  }
  __device__ static void prepare(uint8_t*, uint8_t*, int) {}
  __device__ static const uint8_t* kptr(const uint8_t* ring, int j) {
    return ring + (j % kStages) * 2 * kTile;
  }
  __device__ static const uint8_t* vptr(const uint8_t* ring, int j) {
    return kptr(ring, j) + kTile;
  }

  // S[64 x kStep] = Q K^T for the warpgroup's 64 rows of the q-tile:
  // issued and committed, not waited for.  A k16 step is 32 bytes into a
  // row, and every 4 steps the next atom.
  __device__ static void qk(float (&s)[kStep / 2], const uint8_t* q, const uint8_t* k) {
    const uint32_t sa = smem_u32(q) + (threadIdx.x >> 7) * (64 * 128), sb = smem_u32(k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk)
      wgmma_ss<kF16>(s, wgmma_desc(sa + (kk >> 2) * (kQRows * 128) + (kk & 3) * 32, 16, 1024),
                     wgmma_desc(sb + (kk >> 2) * (kStep * 128) + (kk & 3) * 32, 16, 1024));
    wgmma_commit();
  }

  // P rounded to T: the accumulator of n8 blocks 2c and 2c + 1 is the A
  // fragment of k16 step c
  __device__ static void pack(A& a, const float (&p)[kStep / 2]) { pack_a16<kF16, kStep>(a, p); }

  // acc[64 x kCols] += P V: V's kStep rows read MN-major, one 64-column
  // atom per wgmma (LBO: the next atom; SBO: the next 8 rows; a k16 step
  // is 16 rows).  Issued and committed, not waited for.
  __device__ static void pv(float (&acc)[kCols / 2], const A& a, const uint8_t* v) {
    const uint32_t sb = smem_u32(v);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kCols / 64; ++h)
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk)
        wgmma_rs<kF16>(*reinterpret_cast<float(*)[32]>(acc + 32 * h), a[kk],
                       wgmma_desc(sb + h * (kStep * 128) + kk * 2048, kStep * 128, 1024));
    wgmma_commit();
  }
};

// ---- the tf32x3 route on mma.sync: float32 at DB = 128

template <int DB>
struct Tf32x3 {
  using T = float;
  using U = uint32_t;
  using L = Padded<DB>;
  static constexpr int kCols = DB;
  static constexpr int kLd = L::kLd;
  static constexpr int kRoute = 2;
  static constexpr int kQRows = 64;  // four warps of 16 rows
  static constexpr int kThreads = 128;
  // 32 keys a step: at DB = 128 a block takes 199 KB of shared memory
  static constexpr int kStep = 32;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = 2 * L::template bytes<kQRows>();
  static constexpr int kKBytes = 2 * L::template bytes<kStep>();
  static constexpr int kVBytes = kKBytes;
  static constexpr int kSmem = kQBytes + kStages * (kKBytes + kVBytes) + 1024;

  // the R-row tile at x becomes its hi part in place, its lo part the tile
  // after it; every thread of the block takes a share
  template <int R>
  __device__ static void split(uint8_t* x) {
    float* hi = reinterpret_cast<float*>(x);
    float* lo = hi + R * kLd;
    for (int i = threadIdx.x; i < R * (DB / 4); i += kThreads) {
      const int at = (i / (DB / 4)) * kLd + (i % (DB / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(hi + at);
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    }
  }

  __device__ static void split_q(uint8_t* q) { split<kQRows>(q); }
  __device__ static void split_kv(uint8_t* k, uint8_t* v) {
    split<kStep>(k);
    split<kStep>(v);
  }

  // S[64 x kStep] = Q K^T, the warp's 16 rows against the step's keys
  // (fragments: rows g, g + 8 of A and columns t, t + 4 of a k8 step; B
  // row 8j + g), from the split tiles
  __device__ static void qk(float (&s)[kStep / 2], const uint8_t* q, const uint8_t* k) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
    const uint32_t* Qh = reinterpret_cast<const uint32_t*>(q) + (warp * 16 + g) * kLd + t;
    const uint32_t* Ql = Qh + kQRows * kLd;
    const uint32_t* Kh = reinterpret_cast<const uint32_t*>(k) + g * kLd + t;
    const uint32_t* Kl = Kh + kStep * kLd;
#pragma unroll
    for (int kk = 0; kk < DB / 8; ++kk) {
      const int c = kk * 8;
      const uint32_t ah[4] = {Qh[c], Qh[8 * kLd + c], Qh[c + 4], Qh[8 * kLd + c + 4]};
      const uint32_t al[4] = {Ql[c], Ql[8 * kLd + c], Ql[c + 4], Ql[8 * kLd + c + 4]};
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
        const int o = j * 8 * kLd + c;
        mma_3xtf32(s + 4 * j, ah, al, Kh[o], Kh[o + 4], Kl[o], Kl[o + 4]);
      }
    }
  }

  // acc[64 x DB] += P V: k8 step c takes P's n8 block c with logical k t
  // and t + 4 standing for columns 2t and 2t + 1, so V's rows are read in
  // the same order, 8c + 2t and 8c + 2t + 1
  __device__ static void pv(float (&acc)[kCols / 2], const float (&p)[kStep / 2],
                            const uint8_t* v) {
    const int g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
    const uint32_t* Vh = reinterpret_cast<const uint32_t*>(v) + 2 * t * kLd + g;
    const uint32_t* Vl = Vh + kStep * kLd;
#pragma unroll
    for (int c = 0; c < kStep / 8; ++c) {
      uint32_t ah[4], al[4];
      split_tf32(p[4 * c], ah[0], al[0]);
      split_tf32(p[4 * c + 2], ah[1], al[1]);
      split_tf32(p[4 * c + 1], ah[2], al[2]);
      split_tf32(p[4 * c + 3], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int o = 8 * c * kLd + 8 * j;
        mma_3xtf32(acc + 4 * j, ah, al, Vh[o], Vh[o + kLd], Vl[o], Vl[o + kLd]);
      }
    }
  }
};

// ---- the tf32x3 route on wgmma: float32 at DB <= 64

// A 128-row q-tile owned by two warpgroups, 64 keys a step, as the wgmma
// route, on tf32 wgmma (m64nNk8) for both products, from float32 tiles in
// 128-byte swizzled atoms of 32 columns.  tf32 has no transpose flag, so
// the split pass writes V transposed (d rows, keys K-major, the keys of
// each 8 in the order 0 2 4 6 1 3 5 7: P's accumulator fragment is then
// its A fragment, as on mma.sync).  Q, K and V^T are split once each.  A
// slot holds K and its lo and V^T and its lo; V lands in one staging tile
// and is split into the slot of its stage, so two slots hold stages j - 1
// (V^T) and j, and stage j + 1's K lands in the slot of j - 1.
template <int DB>
struct Tf32x3Wgmma {
  using T = float;
  using U = uint32_t;
  using L = Swizzled<DB, 4>;
  static constexpr int kCols = L::kCols;
  static constexpr int kRoute = 2;
  static constexpr int kQRows = 128;
  static constexpr int kThreads = 256;
  static constexpr int kStep = 64;
  static constexpr int kStages = 2;
  static constexpr int kPrefetch = 1;  // one staging tile
  static constexpr bool kSplit = true;
  // a K tile, and a V^T tile (kCols rows of kStep keys, layout LT)
  static constexpr int kTile = L::template bytes<kStep>();
  using LT = Swizzled<kStep, 4>;
  // Q and its lo; the slots [K, lo, V^T, lo] and the staging tile
  static constexpr int kQBytes = 2 * L::template bytes<kQRows>();
  static constexpr int kRingBytes = kStages * 4 * kTile + kTile;
  static constexpr int kSmem = kQBytes + kRingBytes + 1024;
  struct A {  // P as the A operand, split
    uint32_t h[kStep / 8][4], l[kStep / 8][4];
  };

  template <typename Src>
  __device__ static void load(uint8_t* ring, int j, Src kb, Src vb, int sk, int d, bool vec) {
    load_tile<L, kStep, kThreads>(ring + (j % kStages) * 4 * kTile, kb, j * kStep, sk, d, vec);
    load_tile<L, kStep, kThreads>(ring + kStages * 4 * kTile, vb, j * kStep, sk, d, vec);
  }
  __device__ static const uint8_t* kptr(const uint8_t* ring, int j) {
    return ring + (j % kStages) * 4 * kTile;
  }
  __device__ static const uint8_t* vptr(const uint8_t* ring, int j) {
    return kptr(ring, j) + 2 * kTile;
  }

  // the tile of BYTES at x becomes its hi part in place, its lo part the
  // tile after it (the same layout)
  template <int BYTES>
  __device__ static void split_flat(uint8_t* x) {
    uint4* hi = reinterpret_cast<uint4*>(x);
    uint4* lo = reinterpret_cast<uint4*>(x + BYTES);
    for (int i = threadIdx.x; i < BYTES / 16; i += kThreads) {
      const uint4 v = hi[i];
      uint4 h, l;
      split_tf32(__uint_as_float(v.x), h.x, l.x);
      split_tf32(__uint_as_float(v.y), h.y, l.y);
      split_tf32(__uint_as_float(v.z), h.z, l.z);
      split_tf32(__uint_as_float(v.w), h.w, l.w);
      hi[i] = h;
      lo[i] = l;
    }
  }

  // stage j as the products read it: Q split at the first stage; K split
  // in place; V from the staging tile transposed and split into the slot
  __device__ static void prepare(uint8_t* q, uint8_t* ring, int j) {
    if (j == 0) split_flat<L::template bytes<kQRows>()>(q);
    uint8_t* const k = ring + (j % kStages) * 4 * kTile;
    split_flat<kTile>(k);
    const uint8_t* const v = ring + kStages * 4 * kTile;
    uint8_t* const th = k + 2 * kTile;
    uint8_t* const tl = th + kTile;
    for (int i = threadIdx.x; i < kStep * kCols; i += kThreads) {
      const int r = i / kCols, n = i % kCols;  // key r, column n
      const float x = *reinterpret_cast<const float*>(
          v + L::template chunk<kStep>(r, n >> 2) + (n & 3) * 4);
      uint32_t h, l;
      split_tf32(x, h, l);
      const int pos = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
      const uint32_t at = LT::template chunk<kCols>(n, pos >> 2) + (pos & 3) * 4;
      *reinterpret_cast<uint32_t*>(th + at) = h;
      *reinterpret_cast<uint32_t*>(tl + at) = l;
    }
  }

  // S[64 x kStep] = Q K^T for the warpgroup's 64 rows: lo*hi + hi*lo +
  // hi*hi a k8 step (32 bytes into a row; every 4 steps the next atom).
  // Issued and committed, not waited for.
  __device__ static void qk(float (&s)[kStep / 2], const uint8_t* q, const uint8_t* k) {
    const uint32_t qh = smem_u32(q) + (threadIdx.x >> 7) * (64 * 128);
    const uint32_t ql = qh + L::template bytes<kQRows>();
    const uint32_t kh = smem_u32(k), kl = kh + kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 8; ++kk) {
      const uint32_t oa = (kk >> 2) * (kQRows * 128) + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * (kStep * 128) + (kk & 3) * 32;
      wgmma_tf32_ss(s, wgmma_desc(ql + oa, 16, 1024), wgmma_desc(kh + ob, 16, 1024));
      wgmma_tf32_ss(s, wgmma_desc(qh + oa, 16, 1024), wgmma_desc(kl + ob, 16, 1024));
      wgmma_tf32_ss(s, wgmma_desc(qh + oa, 16, 1024), wgmma_desc(kh + ob, 16, 1024));
    }
    wgmma_commit();
  }

  // P split: its n8 block c is the A fragment of k8 step c (logical k t
  // and t + 4 are columns 2t and 2t + 1, the order of V^T's keys)
  __device__ static void pack(A& a, const float (&p)[kStep / 2]) {
#pragma unroll
    for (int c = 0; c < kStep / 8; ++c) {
      split_tf32(p[4 * c], a.h[c][0], a.l[c][0]);
      split_tf32(p[4 * c + 2], a.h[c][1], a.l[c][1]);
      split_tf32(p[4 * c + 1], a.h[c][2], a.l[c][2]);
      split_tf32(p[4 * c + 3], a.h[c][3], a.l[c][3]);
    }
  }

  // acc[64 x kCols] += P V from V^T and its lo.  Issued and committed.
  __device__ static void pv(float (&acc)[kCols / 2], const A& a, const uint8_t* v) {
    const uint32_t th = smem_u32(v), tl = th + kTile;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kStep / 8; ++c) {
      const uint32_t ob = (c >> 2) * (kCols * 128) + (c & 3) * 32;
      wgmma_tf32_rs(acc, a.l[c], wgmma_desc(th + ob, 16, 1024));
      wgmma_tf32_rs(acc, a.h[c], wgmma_desc(tl + ob, 16, 1024));
      wgmma_tf32_rs(acc, a.h[c], wgmma_desc(th + ob, 16, 1024));
    }
    wgmma_commit();
  }
};

// the wgmma routes: one (q-tile, batch*head) a block, two warpgroups of 64
// rows (thread: warp w, lane 4g + t, rows 16w + g (+8); of each n8 column
// block j, columns 8j + 2t (+1) of S and O).  The products of step j are
// S_j = Q K_j^T and O += P_{j-1} V_{j-1}, issued together: the softmax of
// S_j runs while P_{j-1} V_{j-1} is on the tensor cores, and O is rescaled
// once that is done.  One barrier a step (two with a split pass).
template <class R>
__global__ void __launch_bounds__(R::kThreads)
flash_fwd_wgmma_kernel(const typename R::U* __restrict__ q,
                       const typename R::U* __restrict__ k,
                       const typename R::U* __restrict__ v,
                       typename R::T* __restrict__ o, float* __restrict__ lse, int sq,
                       int sk, int d, int num_q, float sm_scale, int causal, int vec) {
  using L = typename R::L;
  constexpr int QR = R::kQRows, BK = R::kStep, NT = R::kThreads;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sQ = aligned_smem(smem_raw);
  uint8_t* const ring = sQ + R::kQBytes;

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  int qt;
  int64_t bh;
  block_tile(num_q, qt, bh);
  const int q0 = qt * QR;
  const int q_last = min(q0 + QR, sq) - 1;
  // causal: K tiles that start past the tile's last row are wholly masked
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int nk = (k_end + BK - 1) / BK;
  const typename R::U* kb = k + bh * sk * d;
  const typename R::U* vb = v + bh * sk * d;

  constexpr int P = R::kPrefetch;
  load_tile<L, QR, NT>(sQ, q + bh * sq * d, q0, sq, d, vec);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < nk) R::load(ring, j, kb, vb, sk, d, vec);
    cp_async_commit();
  }

  int row[2];
  float m[2], l[2], corr[2];  // the row maxima in log2 units; this thread's share of the sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  const int row0 = q0 + 16 * warp;
  const float scale_log2 = sm_scale * kLog2e;
  float acc[R::kCols / 2];
#pragma unroll
  for (int i = 0; i < R::kCols / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  typename R::A a;

  // stage j ready for the products (its copies landed, split if the route
  // splits) and stage j + P's copies issued, into the slot of j - 2 (or
  // with one staging tile of j - 1, whose K is done and V split away)
  auto stage = [&](int j) {
    cp_async_wait<P - 1>();
    fence_proxy_async();
    __syncthreads();
    if constexpr (R::kSplit) {
      R::prepare(sQ, ring, j);
      fence_proxy_async();
      __syncthreads();
    }
    if (j + P < nk) R::load(ring, j + P, kb, vb, sk, d, vec);
    cp_async_commit();
  };
  auto zero_s = [&] {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  };

  stage(0);
  zero_s();
  R::qk(s, sQ, R::kptr(ring, 0));
  wgmma_wait<0>();
  fence_acc(s);
  online_softmax<BK>(s, m, l, corr, row, row0, 0, t, sk, causal, scale_log2);
  R::pack(a, s);

#pragma unroll 1
  for (int j = 1; j < nk; ++j) {
    stage(j);
    zero_s();
    R::qk(s, sQ, R::kptr(ring, j));
    R::pv(acc, a, R::vptr(ring, j - 1));
    wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
    fence_acc(s);
    online_softmax<BK>(s, m, l, corr, row, row0, j * BK, t, sk, causal, scale_log2);
    wgmma_wait<0>();
    fence_acc(acc);
    rescale(acc, corr);
    R::pack(a, s);
  }
  R::pv(acc, a, R::vptr(ring, nk - 1));
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  write_out(acc, m, l, row, t, sq, d, bh, o, lse);
}

// the tf32x3 route on mma.sync: one (64-row q-tile, batch*head) a block,
// four warps of 16 rows; each step waits for its stage, splits it, and
// runs S = Q K^T, the softmax and O += P V in turn
template <class R>
__global__ void __launch_bounds__(R::kThreads)
flash_fwd_mma_kernel(const typename R::U* __restrict__ q,
                     const typename R::U* __restrict__ k,
                     const typename R::U* __restrict__ v,
                     typename R::T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int d, int num_q, float sm_scale, int causal, int vec) {
  using L = typename R::L;
  constexpr int QR = R::kQRows, BK = R::kStep, NT = R::kThreads, S = R::kStages;
  constexpr int TS = R::kKBytes + R::kVBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sQ = aligned_smem(smem_raw);
  uint8_t* const ring = sQ + R::kQBytes;  // slot s: K at ring + s TS, then V

  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  int qt;
  int64_t bh;
  block_tile(num_q, qt, bh);
  const int q0 = qt * QR;
  const int q_last = min(q0 + QR, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int nk = (k_end + BK - 1) / BK;
  const typename R::U* kb = k + bh * sk * d;
  const typename R::U* vb = v + bh * sk * d;

  // K and V tiles j into slot j % S
  auto load_stage = [&](int j) {
    uint8_t* st = ring + (j % S) * TS;
    load_tile<L, BK, NT>(st, kb, j * BK, sk, d, vec);
    load_tile<L, BK, NT>(st + R::kKBytes, vb, j * BK, sk, d, vec);
  };
  load_tile<L, QR, NT>(sQ, q + bh * sq * d, q0, sq, d, vec);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < nk) load_stage(j);
    cp_async_commit();
  }

  int row[2];
  float m[2], l[2], corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  const int row0 = q0 + 16 * warp;
  const float scale_log2 = sm_scale * kLog2e;
  float acc[R::kCols / 2];
#pragma unroll
  for (int i = 0; i < R::kCols / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < nk; ++j) {
    // into the slot of stage j - 1, which every thread has finished with
    if (j + S - 1 < nk) load_stage(j + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();  // stage j (and Q) has landed
    uint8_t* const sK = ring + (j % S) * TS;
    uint8_t* const sV = sK + R::kKBytes;
    __syncthreads();
    if (j == 0) R::split_q(sQ);
    R::split_kv(sK, sV);
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    R::qk(s, sQ, sK);
    online_softmax<BK>(s, m, l, corr, row, row0, j * BK, t, sk, causal, scale_log2);
    rescale(acc, corr);
    R::pv(acc, s, sV);
    __syncthreads();  // the stage is consumed before the next load into it
  }
  cp_async_wait<0>();
  write_out(acc, m, l, row, t, sq, d, bh, o, lse);
}

}  // namespace tc

// ------------------------------------------ the CUDA cores: DB = 256

namespace cc {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// 256 threads as a 16 x 16 grid: thread (ty, tx) owns rows ty + 16 i and
// score columns tx + 16 j (i, j < 4) of the tile and output columns
// tx + 16 c of O; Q, K, V and P in shared memory as float32
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int d, int num_q,
                 float sm_scale, int causal) {
  constexpr int LD = D + 1;      // padded row of Q and K
  constexpr int LDP = kBK + 1;   // padded row of P
  constexpr int DC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qt = num_q - 1 - (int)(blockIdx.x % num_q);
  const int64_t bh = blockIdx.x / num_q;
  const int q0 = qt * kBQ;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = q0 + r;
    sQ[r * LD + c] = gr < sq && c < d ? to_f32(qb[(int64_t)gr * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int gr = k0 + r;
      const bool in = gr < sk && c < d;
      sK[r * LD + c] = in ? to_f32(kb[(int64_t)gr * d + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vb[(int64_t)gr * d + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (col >= sk) x = -INFINITY;             // ragged edge: p = 0
        else if (causal && col > row) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off, 16);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully-masked rows
    T* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (tx + 16 * c < d) store(orow + tx + 16 * c, acc[i][c] / li);
    if (tx == 0) lse[bh * sq + row] = m[i] + logf(li);
  }
}

}  // namespace cc

// ------------------------------------------------------- the launches

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
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
  using type = std::conditional_t<DB <= 64, tc::Tf32x3Wgmma<DB>, tc::Tf32x3<DB>>;
};

// the kernel of a tensor-core route
template <class R>
auto tc_kernel() {
  if constexpr (std::is_same<R, tc::Tf32x3<R::kCols>>::value)
    return tc::flash_fwd_mma_kernel<R>;
  else
    return tc::flash_fwd_wgmma_kernel<R>;
}

template <class R>
cudaError_t launch_tc(const Args& a) {
  constexpr int smem = R::kSmem;
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = tc_kernel<R>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using U = typename R::U;
  // the 16-byte copies need d a multiple of a chunk and aligned rows
  const auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = a.d % R::L::kElems == 0 && al(a.q) && al(a.k) && al(a.v);
  const int num_q = (a.sq + R::kQRows - 1) / R::kQRows;
  const unsigned grid = (unsigned)((int64_t)num_q * a.bh);
  kern<<<grid, R::kThreads, smem, a.stream>>>(
      static_cast<const U*>(a.q), static_cast<const U*>(a.k),
      static_cast<const U*>(a.v), static_cast<typename R::T*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.d, num_q, a.sm_scale, a.causal, vec);
  return cudaGetLastError();
}

// the CUDA-core kernel of the 256 bucket as a route
template <typename T_>
struct CudaCores {
  using T = T_;
  static constexpr int kRoute = 0;
  static constexpr int kThreads = cc::kThreads;
  static constexpr int kQRows = cc::kBQ;
  static constexpr int kStep = cc::kBK;
  static constexpr int kStages = 1;  // K and V loaded in place each step
  static constexpr int kSmem = (int)cc::smem_bytes<256>();
};

template <typename T>
cudaError_t launch_cc(const Args& a) {
  constexpr int D = 256;
  constexpr int smem = CudaCores<T>::kSmem;
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = cc::flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int num_q = (a.sq + cc::kBQ - 1) / cc::kBQ;
  const unsigned grid = (unsigned)((int64_t)num_q * a.bh);
  kern<<<grid, cc::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.d, num_q, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <class R>
struct Tag {
  using type = R;
};

// f(Tag<route>, bucket) for the smallest head-dim bucket that holds d and
// its route in type T: the launch and its plan both take it from here
// (ops/attention.py fwd_launch_plan picks the same)
template <typename T, class F>
cudaError_t dispatch_d(int d, F&& f) {
  if (d >= 1 && d <= 32) return f(Tag<typename Route<32, T>::type>{}, 32);
  if (d > 32 && d <= 64) return f(Tag<typename Route<64, T>::type>{}, 64);
  if (d > 64 && d <= 128) return f(Tag<typename Route<128, T>::type>{}, 128);
  if (d > 128 && d <= 256) return f(Tag<CudaCores<T>>{}, 256);
  return cudaErrorInvalidValue;
}

template <class F>
cudaError_t dispatch(int dtype, int d, F&& f) {
  if (dtype == 0) return dispatch_d<float>(d, f);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, f);
  if (dtype == 2) return dispatch_d<__half>(d, f);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: contiguous (bh, s, d) arrays of one type; lse: (bh, sq) float32.
// dtype 0 is float32, 1 is bfloat16, 2 is float16; 1 <= d <= 256.
// Returns the launch's cudaError_t.
extern "C" int mxt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int sq, int sk,
                                  int d, float sm_scale, int causal, int dtype,
                                  void* stream) {
  const Args a{q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, d, [&](auto route, int) {
    using R = typename decltype(route)::type;
    if constexpr (R::kRoute == 0)
      return launch_cc<typename R::T>(a);
    else
      return launch_tc<R>(a);
  });
}

// The plan that mxt_flash_attn_fwd launches at head dim d in dtype, into
// out[7]: route (0 "cuda_cores", 1 "wgmma", 2 "tf32x3"), bucket, threads,
// q-tile rows, keys a step, ring stages, dynamic shared memory in bytes
// (ops/attention.py FwdLaunchPlan's fields).  Returns cudaErrorInvalidValue
// where the launch would.
extern "C" int mxt_flash_attn_fwd_plan(int d, int dtype, int* out) {
  return (int)dispatch(dtype, d, [&](auto route, int bucket) {
    using R = typename decltype(route)::type;
    const int plan[7] = {R::kRoute, bucket,     R::kThreads, R::kQRows,
                         R::kStep,  R::kStages, R::kSmem};
    for (int i = 0; i < 7; ++i) out[i] = plan[i];
    return cudaSuccess;
  });
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
