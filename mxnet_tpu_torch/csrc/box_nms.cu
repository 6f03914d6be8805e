// Greedy non-maximum suppression (K7) for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel.  The JAX package runs box_nms
// (mxnet_tpu/ops/contrib.py:62-107) as a lax.fori_loop over all N sorted
// rows, which XLA compiles into one device loop.  Written in plain PyTorch,
// that loop is N sequential steps of several launches each: at SSD300's
// 8,732 anchors and batch 32, MultiBoxDetection would make about 150,000
// launches a call.  This file computes the same keep set in two launches.
//
// The function.  An image's rows are sorted by score, descending (the
// wrapper sorts, as the JAX package's argsort lies outside any kernel);
// the first n_valid[b] of them are valid (score > valid_thresh and rank <
// topk: a prefix of the sorted order).  In order, a valid row that is
// still kept removes every later row j whose IoU with it is above the
// threshold and whose class id equals its own (any class when ids is
// null: force_suppress, or id_index < 0).  keep[b][i] = 1 for the rows
// that survive and are valid, 0 for every other row.  The IoU is
// _corner_iou's (contrib.py:26-41) in float32 with the same operations in
// the same order, each rounded (no contraction into fma), 0 where the
// union is not positive; NaN propagates through max and min as in
// jnp.maximum, and a NaN id matches no id.  So the keep set equals the
// plain version's (ops/box_nms.py nms_keep_plain) bit for bit.
//
// Design:
//   - Pass 1 (nms_mask_kernel): a block of 64 threads takes 64 rows of an
//     image against 64 columns, the column boxes in shared memory; each
//     thread writes one 64-bit word, bit jj set when row i suppresses
//     column col0 + jj > i.  Only the valid prefix is worked, and only
//     the tiles on or above the diagonal: blocks past n_valid[b] exit.
//     The mask holds limit rows of ceil(limit / 64) words an image, limit
//     = topk where topk is given, else N (306 MB at (32, 8732)).
//   - Pass 2 (nms_walk_kernel): one block an image walks its valid rows in
//     order, the removed bits of every row in shared memory (137 words at
//     8,732 rows); a row not yet removed is kept and ORs its mask row,
//     from its own word on, into the removed bits, then the block syncs.
//     A removed row costs one shared-memory read and no sync.
//
// Bound on the H100: operations.  At (32, 8732) the boxes are read once
// (4.5 MB) and keep written once (0.28 MB), 1.4 us at 3.35 TB/s; the IoUs
// take 13 float32 operations a pair of valid rows (each box's area once),
// n_valid^2 / 2 pairs an image: 15.9 GFLOP with every row valid, 0.24 ms
// at the float32 peak of 67 TFLOP/s (chip_smoke.py's nms_bound_ms counts
// the pairs of its inputs).  Pass 2 is sequential in the kept rows (one
// dependent global read and one block sync each), which no bound counts:
// a simple kernel first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows and columns of a pass-1 block
constexpr int kWalkThreads = 256;  // threads of a pass-2 block

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float clip0(float a) { return max_nan(a, 0.f); }

// IoU of corner boxes a and b, in _corner_iou's order of operations
__device__ __forceinline__ float corner_iou(float4 a, float4 b) {
  const float ix1 = max_nan(a.x, b.x), iy1 = max_nan(a.y, b.y);
  const float ix2 = min_nan(a.z, b.z), iy2 = min_nan(a.w, b.w);
  const float iw = clip0(__fsub_rn(ix2, ix1));
  const float ih = clip0(__fsub_rn(iy2, iy1));
  const float inter = __fmul_rn(iw, ih);
  const float area_a =
      __fmul_rn(clip0(__fsub_rn(a.z, a.x)), clip0(__fsub_rn(a.w, a.y)));
  const float area_b =
      __fmul_rn(clip0(__fsub_rn(b.z, b.x)), clip0(__fsub_rn(b.w, b.y)));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ ids,
                const int* __restrict__ n_valid,
                unsigned long long* __restrict__ mask, int n, int limit,
                int words, float thresh) {
  const int b = blockIdx.z;
  const int nv = min(n_valid[b], limit);
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  // tiles left of the diagonal hold only j < i: pass 2 never reads them
  if (row0 >= nv || col0 >= nv || blockIdx.x < blockIdx.y) return;
  __shared__ float4 cbox[kTile];
  __shared__ float cid[kTile];
  const int t = threadIdx.x;
  const int64_t img = (int64_t)b * n;
  if (col0 + t < nv) {
    cbox[t] = boxes[img + col0 + t];
    cid[t] = ids ? ids[img + col0 + t] : 0.f;
  }
  __syncthreads();
  const int i = row0 + t;
  if (i >= nv) return;
  const float4 bi = boxes[img + i];
  const float id_i = ids ? ids[img + i] : 0.f;
  const int cols = min(kTile, nv - col0);
  unsigned long long bits = 0ull;
  for (int jj = max(0, i + 1 - col0); jj < cols; ++jj) {
    if (ids && !(cid[jj] == id_i)) continue;
    if (corner_iou(bi, cbox[jj]) > thresh) bits |= 1ull << jj;
  }
  mask[((int64_t)b * limit + i) * words + blockIdx.x] = bits;
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const unsigned long long* __restrict__ mask,
                const int* __restrict__ n_valid, uint8_t* __restrict__ keep,
                int n, int limit, int words) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int nv = min(n_valid[b], limit);
  const int nw = (nv + kTile - 1) / kTile;
  uint8_t* kb = keep + (int64_t)b * n;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) removed[w] = 0ull;
  for (int i = threadIdx.x; i < n; i += blockDim.x) kb[i] = 0;
  __syncthreads();
  const unsigned long long* mb = mask + (int64_t)b * limit * words;
  for (int i = 0; i < nv; ++i) {
    // uniform across the block: row i's own bit is set by earlier rows only
    if ((removed[i >> 6] >> (i & 63)) & 1ull) continue;
    if (threadIdx.x == 0) kb[i] = 1;
    const unsigned long long* row = mb + (int64_t)i * words;
    for (int w = (i >> 6) + threadIdx.x; w < nw; w += blockDim.x)
      removed[w] |= row[w];
    __syncthreads();
  }
}

}  // namespace

// boxes float32 (B, N, 4) corner rows sorted by score, descending; ids
// float32 (B, N) or null (every row one class); n_valid int32 (B,); mask
// scratch of B * limit * ceil(limit / 64) 64-bit words; keep (B, N) bytes.
extern "C" int mxt_box_nms(const void* boxes, const void* ids,
                           const void* n_valid, void* mask, void* keep, int b,
                           int n, int limit, float thresh, void* stream) {
  if (b <= 0 || n <= 0 || limit <= 0 || limit > n || b > 65535 ||
      (reinterpret_cast<uintptr_t>(boxes) & 15) != 0)
    return cudaErrorInvalidValue;
  const int tiles = (limit + kTile - 1) / kTile;
  const int words = tiles;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (tiles > 65535 || smem > 48 * 1024) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(tiles, tiles, b), kTile, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(ids),
      static_cast<const int*>(n_valid),
      static_cast<unsigned long long*>(mask), n, limit, words, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_walk_kernel<<<b, kWalkThreads, smem, st>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int*>(n_valid), static_cast<uint8_t*>(keep), n, limit,
      words);
  return cudaGetLastError();
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
