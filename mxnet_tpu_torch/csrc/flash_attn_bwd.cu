// Flash-attention backward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces mxnet_tpu/ops/attention.py::_bwd_dq_kernel (K4a) and
// ::_bwd_dkv_kernel (K4b), the Pallas TPU kernels behind _bwd_pallas.  They
// compute the same functions, from the forward's lse and
// delta = rowsum(dO * O) (both float32, per query row):
//   s  = Q K^T * sm_scale              [causal: masked where col > row]
//   p  = exp(s - lse)                  (0 where masked)
//   dp = dO V^T,  ds = p * (dp - delta) * sm_scale
//   K4a: dQ = ds K            K4b: dV = p^T dO,  dK = ds^T Q
// with every product and sum in float32 whatever the input type, and dQ,
// dK, dV written in the input type.  The causal mask is top-left aligned
// on absolute indices (col > row), also when Sq != Sk.
//
// Design.  The Pallas grids walk one axis sequentially and carry the
// accumulator across grid steps in VMEM.  Here one thread block owns one
// output tile and runs that loop itself, with the accumulator in registers,
// so every output element is written by exactly one block: there are no
// atomics and the gradients are the same bit for bit from run to run.
//  - K4a: one block per (64-row q-tile, batch*head).  Q and dO stay in
//    shared memory; the block walks the K/V tiles, up to the diagonal when
//    causal, and accumulates dQ in registers.
//  - K4b: one block per (64-row k-tile, batch*head).  K and V stay in
//    shared memory; the block walks the Q/dO tiles, from the first one that
//    reaches the diagonal when causal, and accumulates dK and dV in
//    registers.  The score tile is computed transposed (keys down, queries
//    across) so that each thread's rows of P^T and dS^T are the rows of dK
//    and dV it owns.
// The thread grain is the forward's (flash_attn_fwd.cu): 256 threads as a
// 16 x 16 grid, a (BQ/16) x (BK/16) micro-tile of the BQ x BK score tile
// per thread, float32 tiles with rows padded by one float so that the
// strided reads of the dot-product loops hit 32 distinct banks.  One P/dS
// tile is shared; K4b writes P, accumulates dV, then overwrites it with dS.
// Shared memory: 4 tiles of rows x (DB+1) plus the P/dS tile (plus 2 x BQ
// row scalars in K4b), set with cudaFuncSetAttribute.  Tiles are 64 x 64
// (83 KB at DB=64, 149 KB at DB=128); at DB=256 they would take 273 KB,
// past the 227 KB a block may have, so that bucket runs 32 x 32 tiles
// (133 KB), a 2 x 2 micro-tile per thread.
//
// Head dims.  The kernels are instantiated for the head-dim buckets DB in
// {32, 64, 128, 256} and take the runtime head dim d <= DB: columns d..DB
// are loaded as zeros (they add exactly 0) and never stored, and the rows
// of the device arrays have pitch d.  Loads and stores are scalar, so any
// d and row pitch is aligned.  The input type is float32, bf16 or float16.
//
// The ragged edge is masked here: rows past Sq and columns past Sk are
// loaded as zeros, get p = 0 (a zero-padded key has s = 0 and would
// otherwise get p = exp(-lse) != 0), and are never written.  So every shape
// runs the kernels; nothing falls back.
//
// Bound on the H100.  At the training shape (B=8, H=8, S=1024, D=64,
// causal) there are 33.6 M unmasked (row, col) pairs.  K4a does 6*D flops
// per pair (s, dp, dQ): 12.9 GFLOP; K4b 8*D (s, dV, dp, dK): 17.2 GFLOP.
// TF32 stays off, so this is float32 work on the CUDA cores: at 67 TFLOP/s
// the bounds are 0.193 ms and 0.257 ms, against about 84 MB of traffic for
// each kernel, 0.025 ms at 3.35 TB/s.  Both are bound by operations.  This
// first version reads both operands of every multiply-add from shared
// memory (1 load per 2 FMAs); tensor cores (wgmma on bf16, or 3xTF32) and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

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

// K4a: dQ for one (q-tile, batch*head).
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
  // the longest causal rows first: q-tiles run from the last to the first
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
  // causal: K tiles that start past the tile's last row are wholly masked
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

// K4b: dK and dV for one (k-tile, batch*head).
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
  // k-tiles in ascending order: when causal the first ones walk the most
  // q-tiles, so the longest blocks start first
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

  // causal: query rows before k0 see no column of this tile
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

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, d;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// the tile edge of a head-dim bucket: 64, or 32 at DB = 256, where 64 x 64
// tiles would not fit in shared memory
template <int D>
constexpr int tile_rows() { return D > 128 ? 32 : 64; }

template <int D, typename T>
cudaError_t launch_dq(const Args& a) {
  constexpr int B = tile_rows<D>();
  constexpr size_t smem = dq_smem_bytes<D, B, B>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = flash_bwd_dq_kernel<D, B, B, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_q = (a.sq + B - 1) / B;
  const unsigned grid = (unsigned)((int64_t)num_q * a.bh);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.sq, a.sk, a.d, num_q, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv(const Args& a) {
  constexpr int B = tile_rows<D>();
  constexpr size_t smem = dkv_smem_bytes<D, B, B>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = flash_bwd_dkv_kernel<D, B, B, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_k = (a.sk + B - 1) / B;
  const unsigned grid = (unsigned)((int64_t)num_k * a.bh);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.d, num_k,
      a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch_d(const Args& a) {
  // the smallest head-dim bucket that holds d (ops/attention.py
  // head_dim_bucket picks the same)
  const int d = a.d;
  if (d >= 1 && d <= 32) return DQ ? launch_dq<32, T>(a) : launch_dkv<32, T>(a);
  if (d > 32 && d <= 64) return DQ ? launch_dq<64, T>(a) : launch_dkv<64, T>(a);
  if (d > 64 && d <= 128) return DQ ? launch_dq<128, T>(a) : launch_dkv<128, T>(a);
  if (d > 128 && d <= 256) return DQ ? launch_dq<256, T>(a) : launch_dkv<256, T>(a);
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
