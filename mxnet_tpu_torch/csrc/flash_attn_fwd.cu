// Flash-attention forward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces mxnet_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// behind _fwd_pallas).  It computes the same function:
//   O = softmax(Q K^T * sm_scale [causal: -1e30 where col > row]) V
//   lse = m + log(l)                        (per row, float32)
// with scores, the online softmax and both products in float32 whatever
// the input type, O written in the input type, l == 0 taken as 1, and
// K tiles wholly above the diagonal skipped in the causal case.  The
// causal mask is top-left aligned on absolute indices (col > row), also
// when Sq != Sk.
//
// Design.  The Pallas grid walks K sequentially and carries acc, m and l
// across grid steps in VMEM scratch.  Here one thread block owns one
// (q-tile, batch*head) pair and runs the K loop itself, with acc, m and l
// in registers.  Tiles are 64 x 64 (the TPU's 256/512 blocks would not fit
// in shared memory): Q, K, V and the probability tile P live in dynamic
// shared memory, the Q and K rows padded by one float so the strided
// reads of the QK^T loop hit 32 distinct banks.  256 threads form a
// 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and score columns
// tx + 16 j (i, j < 4) of the tile and output columns tx + 16 c of O.
// Row maxima and sums are reduced across the 16 lanes that share a row
// with warp shuffles.  The ragged edge is masked here and not in Python:
// rows past Sq are computed on zeros and never written, columns past Sk
// get a score of -inf and so a probability of exactly 0.  So every shape
// runs the kernel; nothing falls back.
//
// Bound on the H100.  At the serving slice's bucket-8 shape (B=8, H=8,
// S=1024, D=64, causal) the two products take 4 * B*H * D * S(S+1)/2
// = 8.6 GFLOP per layer.  No TF32 is allowed (the logits are compared at
// float32 tolerance), so this is CUDA-core float32 work: 8.6 GFLOP at the
// card's 67 TFLOP/s float32 rate is 0.128 ms, against 67 MB of q/k/v/o
// traffic at 3.35 TB/s, 0.020 ms.  The kernel is bound by operations.
// This first version reads its operands from shared memory for every
// multiply-add (2 loads per 4 FMAs in the QK^T loop); tensor cores
// (wgmma on bf16, or 3xTF32) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the JAX kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

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
  // the longest causal rows first: q-tiles run from the last to the first
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
  // causal: K tiles that start past the tile's last row are wholly masked
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

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int d, float sm_scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_q = (sq + kBQ - 1) / kBQ;
  const unsigned grid = (unsigned)((int64_t)num_q * bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, d, num_q, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int sq, int sk, int d,
                       float sm_scale, int causal, cudaStream_t stream) {
  // the smallest head-dim bucket that holds d (ops/attention.py
  // head_dim_bucket picks the same)
  if (d >= 1 && d <= 32) return launch<32, T>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, stream);
  if (d > 32 && d <= 64) return launch<64, T>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, stream);
  if (d > 64 && d <= 128) return launch<128, T>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, stream);
  if (d > 128 && d <= 256) return launch<256, T>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, s);
  if (dtype == 2)
    return (int)dispatch_d<__half>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
