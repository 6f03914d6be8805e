// Greedy non-maximum suppression (K7) for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel.  The JAX package runs box_nms
// (mxnet_tpu/ops/contrib.py:62-107) as a lax.fori_loop over all N sorted
// rows, which XLA compiles into one device loop.  Written in plain PyTorch,
// that loop is N sequential steps of several launches each: at SSD300's
// 8,732 anchors and batch 32, MultiBoxDetection would make about 150,000
// launches a call.  This file computes the same keep set in a few.
//
// The function.  An image's rows are sorted by score, descending (the
// wrapper sorts, as the JAX package's argsort lies outside any kernel);
// the first n_valid[b] of them are valid (score > valid_thresh and rank <
// topk: a prefix of the sorted order).  In order, a valid row that is
// still kept removes every later row j whose IoU with it is above the
// threshold and whose class id equals its own (any class when ids is
// null: force_suppress, or id_index < 0).  keep[b][i] = 1 for the rows
// that survive and are valid, 0 for every other row.  The IoU is
// _corner_iou's (contrib.py:26-41) in float32, each operation rounded (no
// contraction into fma), 0 where the union is not positive; NaN
// propagates through max and min as in jnp.maximum, and a NaN id matches
// no id.  So the keep set equals the plain version's (ops/box_nms.py
// nms_keep_plain) bit for bit.
//
// Design.  A row suppresses only rows of its own class, so the walk splits
// into one independent walk a class of an image ("segment"):
//   - nms_scan_kernel, one block an image: gives each valid row a class
//     key (the id's bits, -0.0 made 0.0: one class under ==; a NaN id no
//     class) and sorts the keys stably with their rows: a radix sort of
//     four 8-bit passes (a pass whose digit all keys share is skipped), in
//     shared memory up to 12,416 rows.  A class's rows then lie together
//     in score order.  It finds the segments of two rows or more, lists
//     those longer than kWarpRows from the front of the image's list and
//     the others from its back, gathers their boxes in sorted order with
//     each box's area, and writes keep for every other row (not valid: 0;
//     no class, or a class of one row: 1).  On the single-class route
//     (ids null) the valid prefix is the one segment, and nothing is
//     sorted.
//   - nms_walk_kernel, a grid of blocks an image over the whole card: a
//     block walks each long segment it is dealt, and each of its warps
//     each short one (dealt round the blocks, then round their warps).
//     Both resolve 64 rows (a tile) at a time:
//       * warp route: the warp finds the tile's first live row, which is
//         kept, tests it against the tile's later live rows (two a lane,
//         one ballot), and repeats from the next live row: one step a kept
//         row, no barrier.  The tile's kept rows are then tested against
//         every live row of the later tiles, whose removed bits the lanes
//         hold, one 64-bit word a lane.
//       * block route: the removed bits of the segment lie in shared
//         memory (in global scratch past 227 KB of them), and so do its
//         boxes and areas where the plan's limit of rows fits beside them
//         (11,498 rows), copied in first.  In each step, warp 0 tests tile
//         t against the kept rows of tile t-1 and resolves it from the 64
//         suppression words of its diagonal block (bit j of word r: row r
//         removes row j), computed a step ahead by the other warps;
//         meanwhile those warps test tile t-1's kept rows against the
//         later tiles (each tile owned by one warp) and compute tile t+1's
//         words.  One barrier a tile.
//     Only the kept rows of a tile are tested against later rows, and a
//     row already removed is not tested again: the pair tests a segment
//     needs, not every pair.
//
// The pair test (over) is corner_iou(a, c) > thresh, bit for bit, with
// each box's area computed once (the same operations), plain fmaxf/fminf
// for the intersection, and the division only where the intersection
// and the union are positive.  Why that is exact: a NaN coordinate makes
// the box's area NaN, then the union NaN and corner_iou 0; with no NaN
// coordinate fmaxf and fminf equal the NaN-propagating max and min; an
// intersection that is not positive (0, -0 or NaN) makes corner_iou +-0;
// either way the result compares with thresh as 0 does.
//
// Bound on the H100: operations.  corner_iou takes 13 float32 operations
// a pair of valid rows of one class (pairs of two classes need none once
// the rows are partitioned), and each valid box's area once; the boxes
// and ids are read once and keep written once (5.9 MB at (32, 8732), 1.8
// us at 3.35 TB/s).  chip_smoke.py's nms_bound_ms counts both for its
// inputs.  The greedy order keeps a chain of dependent steps, one a kept
// row within a tile and one barrier a tile, which no bound counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // rows resolved together: a 64-bit word
constexpr int kWarps = 32;            // warps of a walk block
constexpr int kWalkThreads = kWarps * 32;
constexpr int kWarpRows = 1024;       // longest segment a warp walks: 16 tiles
constexpr int kScanThreads = 1024;    // threads of a scan block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRadix = 256;           // a sort pass's digits: 8 bits
constexpr int kHistStride = kScanWarps + 1;  // a digit's counts, a warp each
// a scan block's dynamic shared memory before the sort's buffers
constexpr int kScanSmemFixed = kRadix * kHistStride * 4;
constexpr unsigned kNoClass = 0xffffffffu;  // a NaN id's key
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory of a walk block before the removed bits (and the
// boxes of a long segment): two tiles of suppression words, two kept masks
constexpr int kWalkSmemFixed = (2 * kTile + 2) * 8;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

__device__ __forceinline__ float clip0(float a) { return max_nan(a, 0.f); }

// a box's area, in _corner_iou's operations
__device__ __forceinline__ float box_area(float4 a) {
  return __fmul_rn(clip0(__fsub_rn(a.z, a.x)), clip0(__fsub_rn(a.w, a.y)));
}

// corner_iou(a, c) > thresh for the earlier row a and the later row c, of
// areas aa and ca (see the note above)
__device__ __forceinline__ bool over(float4 a, float aa, float4 c, float ca,
                                     float thresh) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(aa, ca), inter);
  // no branch; 1 / 1 where the quotient is not used keeps the division on
  // its fast path
  const bool pos = inter > 0.f && uni > 0.f;
  const float q = __fdiv_rn(pos ? inter : 1.f, pos ? uni : 1.f);
  return (pos ? q : 0.f) > thresh;
}

struct Row {
  float4 box;
  float area;
};

__device__ __forceinline__ unsigned long long ballot64(bool lo, bool hi) {
  return (unsigned long long)__ballot_sync(kFull, lo) |
         ((unsigned long long)__ballot_sync(kFull, hi) << 32);
}

// the rows of a tile after row r
__device__ __forceinline__ unsigned long long after(int r) {
  return r == kTile - 1 ? 0ull : ~0ull << (r + 1);
}

// the first `rows` rows of a tile (rows >= 1)
__device__ __forceinline__ unsigned long long first(int rows) {
  return rows >= kTile ? ~0ull : (1ull << rows) - 1ull;
}

__device__ __forceinline__ int lowest(unsigned long long bits) {
  return __ffsll((long long)bits) - 1;
}

// A segment: `len` rows from sorted position `start` of one image, its
// boxes and areas from box/area on (sorted order; global or shared
// memory), its keep flags written at keep[order[position]].
struct Seg {
  const float4* box;
  const float* area;
  const int* order;
  uint8_t* keep;
  int start, len;

  __device__ __forceinline__ int rows(int t) const {
    return min(kTile, len - t * kTile);
  }
  // the lane's two rows of tile t
  __device__ __forceinline__ void load(int t, int lane, Row& r0,
                                       Row& r1) const {
    const int p0 = t * kTile + lane, p1 = p0 + 32;
    if (p0 < len) r0 = Row{box[p0], area[p0]};
    if (p1 < len) r1 = Row{box[p1], area[p1]};
  }
  __device__ __forceinline__ void write(int t, int lane,
                                        unsigned long long kept) const {
    const int n = rows(t);
    for (int j = lane; j < n; j += 32) {
      const int p = start + t * kTile + j;
      keep[order[p]] = (uint8_t)((kept >> j) & 1ull);
    }
  }
};

// row r of the tile whose rows the lanes hold as r0 (0-31) and r1 (32-63)
// (selected by value: a reference to either would put both in local
// memory)
__device__ __forceinline__ Row bcast(const Row& r0, const Row& r1, int r) {
  const bool hi = r >= 32;
  const int src = r & 31;
  Row o;
  o.box.x = __shfl_sync(kFull, hi ? r1.box.x : r0.box.x, src);
  o.box.y = __shfl_sync(kFull, hi ? r1.box.y : r0.box.y, src);
  o.box.z = __shfl_sync(kFull, hi ? r1.box.z : r0.box.z, src);
  o.box.w = __shfl_sync(kFull, hi ? r1.box.w : r0.box.w, src);
  o.area = __shfl_sync(kFull, hi ? r1.area : r0.area, src);
  return o;
}

// the live rows of a later tile (c0, c1 the lane's) that the kept rows
// `kept` of the tile held as k0, k1 remove
__device__ __forceinline__ unsigned long long push(
    unsigned long long kept, const Row& k0, const Row& k1,
    unsigned long long live, const Row& c0, const Row& c1, int lane,
    float thresh) {
  bool h0 = false, h1 = false;
  // every test made, none waiting on another
#pragma unroll 4
  for (unsigned long long k = kept; k; k &= k - 1ull) {
    const Row a = bcast(k0, k1, lowest(k));
    h0 |= over(a.box, a.area, c0.box, c0.area, thresh);
    h1 |= over(a.box, a.area, c1.box, c1.area, thresh);
  }
  return ballot64(h0, h1) & live;
}

// a segment of at most kWarpRows rows, by one warp
__device__ void warp_walk(const Seg& s, int lane, float thresh) {
  const int nt = (s.len + kTile - 1) / kTile;
  unsigned long long removed = 0ull;  // lane u: the removed rows of tile u
  for (int t = 0; t < nt; ++t) {
    Row a0{}, a1{};
    s.load(t, lane, a0, a1);
    unsigned long long alive =
        ~__shfl_sync(kFull, removed, t) & first(s.rows(t));
    unsigned long long kept = 0ull;
    for (unsigned long long pend = alive; pend;) {
      const int r = lowest(pend);
      kept |= 1ull << r;
      const Row k = bcast(a0, a1, r);
      const bool h0 = over(k.box, k.area, a0.box, a0.area, thresh);
      const bool h1 = over(k.box, k.area, a1.box, a1.area, thresh);
      alive &= ~(ballot64(h0, h1) & after(r));
      pend = alive & after(r);
    }
    s.write(t, lane, kept);
    if (!kept) continue;
    for (int u = t + 1; u < nt; ++u) {
      const unsigned long long live =
          ~__shfl_sync(kFull, removed, u) & first(s.rows(u));
      if (!live) continue;
      Row c0{}, c1{};
      s.load(u, lane, c0, c1);
      const unsigned long long hit =
          push(kept, a0, a1, live, c0, c1, lane, thresh);
      if (lane == u) removed |= hit;
    }
  }
}

// the suppression words of tile t's rows r = r0, r0 + step, ... into dst
__device__ void diag_words(const Seg& s, int t, int r0, int step, int lane,
                           float thresh, unsigned long long* dst) {
  const int rows = s.rows(t);
  Row a0{}, a1{};
  s.load(t, lane, a0, a1);
  for (int r = r0; r < rows; r += step) {
    const Row k = bcast(a0, a1, r);
    const bool h0 = over(k.box, k.area, a0.box, a0.area, thresh);
    const bool h1 = over(k.box, k.area, a1.box, a1.area, thresh);
    const unsigned long long hit = ballot64(h0, h1) & after(r) & first(rows);
    if (lane == 0) dst[r] = hit;
  }
}

// a segment longer than kWarpRows rows, by the whole block; `removed`
// holds a word a tile, `words` two tiles of suppression words, `kmask`
// two kept masks
__device__ void block_walk(const Seg& s, int warp, int lane, float thresh,
                           unsigned long long* removed,
                           unsigned long long* words,
                           unsigned long long* kmask) {
  const int nt = (s.len + kTile - 1) / kTile;
  constexpr int pushers = kWarps - 1;
  for (int u = threadIdx.x; u < nt; u += kWalkThreads) removed[u] = 0ull;
  if (warp > 0) diag_words(s, 0, warp - 1, pushers, lane, thresh, words);
  __syncthreads();
  Row p0{}, p1{};                    // warp 0: the rows of tile t - 1
  unsigned long long prev = 0ull;    // warp 0: the kept rows of tile t - 1
  for (int t = 0; t < nt; ++t) {
    if (warp == 0) {
      Row a0{}, a1{};
      s.load(t, lane, a0, a1);
      unsigned long long alive = ~removed[t] & first(s.rows(t));
      if (prev && alive) alive &= ~push(prev, p0, p1, alive, a0, a1, lane,
                                         thresh);
      const unsigned long long* d = words + (t & 1) * kTile;
      unsigned long long kept = 0ull;
      for (unsigned long long pend = alive; pend;) {
        const int r = lowest(pend);
        kept |= 1ull << r;
        alive &= ~d[r];
        pend = alive & after(r);
      }
      s.write(t, lane, kept);
      if (lane == 0) kmask[t & 1] = kept;
      prev = kept;
      p0 = a0;
      p1 = a1;
    } else {
      const unsigned long long k = t > 0 ? kmask[(t - 1) & 1] : 0ull;
      if (k) {
        Row k0{}, k1{};
        s.load(t - 1, lane, k0, k1);
        // the tiles after t that this warp owns: u % pushers == warp - 1
        const int skip = ((warp - 1 - (t + 1)) % pushers + pushers) % pushers;
        for (int u = t + 1 + skip; u < nt; u += pushers) {
          const unsigned long long live = ~removed[u] & first(s.rows(u));
          if (!live) continue;
          Row c0{}, c1{};
          s.load(u, lane, c0, c1);
          const unsigned long long hit =
              push(k, k0, k1, live, c0, c1, lane, thresh);
          if (lane == 0) removed[u] |= hit;
        }
      }
      if (t + 1 < nt)
        diag_words(s, t + 1, warp - 1, pushers, lane, thresh,
                   words + ((t + 1) & 1) * kTile);
    }
    __syncthreads();
  }
}

// a class id's key: the id's bits made unsigned in the ids' order (-0.0
// made 0.0: one class under ==), kNoClass for a NaN id (no class)
__device__ __forceinline__ unsigned class_key(float id) {
  if (!(id == id)) return kNoClass;
  const unsigned u = __float_as_uint(id == 0.f ? 0.f : id);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the exclusive prefix of v over the block's threads, and their total
__device__ __forceinline__ int block_scan(int v, int* total, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = part[lane];
    int winc = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc += o;
    }
    part[lane] = winc - w;
    if (lane == 31) part[32] = winc;
  }
  __syncthreads();
  const int out = part[warp] + inc - v;
  *total = part[32];
  __syncthreads();
  return out;
}

// ranks of two flags among the block's threads, and their totals
__device__ __forceinline__ void block_ranks(bool f0, bool f1, int* rank,
                                            int* total, int (*part)[33]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m0 = __ballot_sync(kFull, f0), m1 = __ballot_sync(kFull, f1);
  if (lane == 0) {
    part[0][warp] = __popc(m0);
    part[1][warp] = __popc(m1);
  }
  __syncthreads();
  if (warp < 2) {
    const int v = part[warp][lane];
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += o;
    }
    part[warp][lane] = inc - v;
    if (lane == 31) part[warp][32] = inc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  rank[0] = part[0][warp] + __popc(m0 & below);
  rank[1] = part[1][warp] + __popc(m1 & below);
  total[0] = part[0][32];
  total[1] = part[1][32];
  __syncthreads();
}

// One pass of the block's stable radix sort of m keys and their rows by
// the 8 bits at `shift`: each warp counts the digits of its run of m/32
// keys (a warp's equal digits found with one match), the counts are
// prefixed digit by digit and warp by warp, then each warp places its
// keys in order.  A pass whose digit is the same in every key places
// nothing and returns false (small integer ids share their low 16 bits).
// hist holds kRadix x kHistStride ints.
__device__ bool radix_pass(const unsigned* kin, const int* rin, unsigned* kout,
                           int* rout, int m, int shift, int* hist, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kRadix * kHistStride; i += kScanThreads)
    hist[i] = 0;
  __syncthreads();
  const int per = (m + kScanWarps - 1) / kScanWarps;
  const int lo = min(m, warp * per), hi = min(m, lo + per);
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    const unsigned d = j < hi ? (kin[j] >> shift) & (kRadix - 1u)
                              : kRadix + lane;
    const unsigned peers = __match_any_sync(kFull, d);
    if (j < hi && lane == __ffs(peers) - 1)
      hist[d * kHistStride + warp] += __popc(peers);
    __syncwarp();  // a later leader may update the same count
  }
  __syncthreads();
  int all = 0;
  if (threadIdx.x < kRadix)
    for (int w = 0; w < kScanWarps; ++w)
      all += hist[threadIdx.x * kHistStride + w];
  if (__syncthreads_or(all == m)) return false;
  constexpr int kEach = kRadix * kScanWarps / kScanThreads;
  int v[kEach], sum = 0;
  for (int e = 0; e < kEach; ++e) {
    const int q = threadIdx.x * kEach + e;
    v[e] = hist[(q / kScanWarps) * kHistStride + q % kScanWarps];
    sum += v[e];
  }
  int total;
  int run = block_scan(sum, &total, part);
  for (int e = 0; e < kEach; ++e) {
    const int q = threadIdx.x * kEach + e;
    hist[(q / kScanWarps) * kHistStride + q % kScanWarps] = run;
    run += v[e];
  }
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    const unsigned d = j < hi ? (kin[j] >> shift) & (kRadix - 1u)
                              : kRadix + lane;
    const unsigned peers = __match_any_sync(kFull, d);
    if (j < hi) {
      const int pos = hist[d * kHistStride + warp] +
                      __popc(peers & ((1u << lane) - 1u));
      kout[pos] = kin[j];
      rout[pos] = rin[j];
    }
    __syncwarp();
    if (j < hi && lane == __ffs(peers) - 1)
      hist[d * kHistStride + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  return true;
}

// The scan: dynamic shared memory of the histogram, then, where sort_global
// is null, the sort's two buffers of limit keys and rows.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ ids,
                const int* __restrict__ n_valid, float4* __restrict__ sbox,
                float* __restrict__ sarea, int* __restrict__ order,
                int2* __restrict__ pairs, int2* __restrict__ lists,
                int* __restrict__ counts, uint8_t* __restrict__ keep,
                unsigned* sort_global, int n, int limit, int cap) {
  extern __shared__ __align__(16) int scan_smem[];
  __shared__ int part[2][33];
  const int b = blockIdx.x;
  const int nv = min(max(n_valid[b], 0), limit);
  int* hist = scan_smem;
  unsigned* key0 = sort_global
                       ? sort_global + (int64_t)b * 4 * limit
                       : reinterpret_cast<unsigned*>(scan_smem +
                                                     kRadix * kHistStride);
  int* row0 = reinterpret_cast<int*>(key0 + limit);
  unsigned* key1 = key0 + 2 * limit;
  int* row1 = reinterpret_cast<int*>(key0 + 3 * limit);
  const float* ib = ids ? ids + (int64_t)b * n : nullptr;
  uint8_t* kb = keep + (int64_t)b * n;
  // the valid rows' keys in score order; keep 0 for the others
  for (int i = threadIdx.x; i < n; i += kScanThreads) {
    if (i < nv) {
      key0[i] = class_key(ib ? ib[i] : 0.f);
      row0[i] = i;
    } else {
      kb[i] = 0;
    }
  }
  __syncthreads();
  if (ib) {  // four passes, each into the other buffers
    for (int shift = 0; shift < 32; shift += 8) {
      if (!radix_pass(key0, row0, key1, row1, nv, shift, hist, part[0]))
        continue;
      unsigned* k = key0;
      key0 = key1;
      key1 = k;
      int* r = row0;
      row0 = row1;
      row1 = r;
    }
  }
  // the segments: runs of two keys or more (a NaN id's key in none)
  auto key = [&](int p) -> unsigned {
    return p >= 0 && p < nv ? key0[p] : kNoClass;
  };
  int* ob = order + (int64_t)b * limit;
  int2* pb = pairs + (int64_t)b * cap;
  int starts = 0, ends = 0;
  for (int base = 0; base < nv; base += kScanThreads) {
    const int p = base + threadIdx.x;
    bool st = false, en = false;
    if (p < nv) {
      const unsigned k = key0[p];
      const int i = row0[p];
      ob[p] = i;
      const bool in = k != kNoClass;
      st = in && key(p - 1) != k;
      en = in && key(p + 1) != k;
      if (!in || (st && en)) {  // no class, or a class of one row: kept
        kb[i] = 1;
      } else {
        const float4 bx = boxes[(int64_t)b * n + i];
        sbox[(int64_t)b * limit + p] = bx;
        sarea[(int64_t)b * limit + p] = box_area(bx);
      }
    }
    int rank[2], total[2];
    block_ranks(st && !en, en && !st, rank, total, part);
    if (st && !en) pb[starts + rank[0]].x = p;
    if (en && !st) pb[ends + rank[1]].y = p;
    starts += total[0];
    ends += total[1];
  }
  __syncthreads();  // the pairs written above, read below by other threads
  // the segments longer than kWarpRows from the front of the list, the
  // others from its back
  int2* lb = lists + (int64_t)b * cap;
  int nbig = 0, nsmall = 0;
  for (int base = 0; base < starts; base += kScanThreads) {
    const int k = base + threadIdx.x;
    int2 sg = make_int2(0, 0);
    bool big = false, small = false;
    if (k < starts) {
      const int2 pr = pb[k];
      sg = make_int2(pr.x, pr.y - pr.x + 1);
      big = sg.y > kWarpRows;
      small = !big;
    }
    int rank[2], total[2];
    block_ranks(big, small, rank, total, part);
    if (big) lb[nbig + rank[0]] = sg;
    if (small) lb[cap - 1 - (nsmall + rank[1])] = sg;
    nbig += total[0];
    nsmall += total[1];
  }
  if (threadIdx.x == 0) {
    counts[2 * b] = nbig;
    counts[2 * b + 1] = nsmall;
  }
}

__host__ __device__ constexpr int64_t align16(int64_t v) {
  return (v + 15) / 16 * 16;
}

// The walk's dynamic shared memory: kWalkSmemFixed bytes, then the removed
// bits of a long segment (a word a tile) unless removed_global holds them,
// then, where `cached`, the long segment's boxes and areas (limit rows at
// most), copied in before its walk.
__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const float4* __restrict__ sbox,
                const float* __restrict__ sarea,
                const int* __restrict__ order,
                const int2* __restrict__ lists,
                const int* __restrict__ counts, uint8_t* __restrict__ keep,
                unsigned long long* removed_global, int n, int limit,
                int cap, int words, int cached, float thresh) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int b = blockIdx.y, g = blockIdx.x, grid = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* removed =
      removed_global
          ? removed_global + ((int64_t)b * grid + g) * words
          : smem + 2 * kTile + 2;
  float4* cbox = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem) + kWalkSmemFixed +
      (removed_global ? 0 : align16(words * 8)));
  float* carea = reinterpret_cast<float*>(cbox + limit);
  const float4* ibox = sbox + (int64_t)b * limit;
  const float* iarea = sarea + (int64_t)b * limit;
  Seg s{nullptr, nullptr, order + (int64_t)b * limit,
        keep + (int64_t)b * n, 0, 0};
  const int2* lb = lists + (int64_t)b * cap;
  const int nbig = counts[2 * b], nsmall = counts[2 * b + 1];
  for (int i = g; i < nbig; i += grid) {
    s.start = lb[i].x;
    s.len = lb[i].y;
    s.box = ibox + s.start;
    s.area = iarea + s.start;
    if (cached) {
      for (int p = threadIdx.x; p < s.len; p += kWalkThreads) {
        cbox[p] = s.box[p];
        carea[p] = s.area[p];
      }
      s.box = cbox;
      s.area = carea;
      __syncthreads();
    }
    block_walk(s, warp, lane, thresh, removed, smem, smem + 2 * kTile);
  }
  // the short segments, dealt round the blocks, first to those that walk
  // no long one, then round their warps
  const int rel = ((g - nbig) % grid + grid) % grid;
  for (int i = rel + warp * grid; i < nsmall; i += grid * kWarps) {
    s.start = lb[cap - 1 - i].x;
    s.len = lb[cap - 1 - i].y;
    s.box = ibox + s.start;
    s.area = iarea + s.start;
    warp_walk(s, lane, thresh);
  }
}

cudaError_t allow_smem(const void* kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// boxes float32 (B, N, 4) corner rows sorted by score, descending, 16-byte
// aligned; ids float32 (B, N), the rows' class ids, or null (every row one
// class); n_valid int32 (B,); keep (B, N) bytes.  ops/box_nms.py
// launch_plan lays the launch out, and this entry takes its decisions as
// they are: the scratch of scratch_bytes bytes holds its regions at the
// byte offsets `offsets` (boxes, areas and rows in sorted order, pairs,
// lists, counts, the removed bits, the sort's buffers; the last two -1
// where they lie in shared memory); the scan runs a block an image with
// scan_smem bytes of dynamic shared memory, the walk `blocks` blocks an
// image with walk_smem bytes, holding a long segment's boxes where
// `cached`.  The entry only checks that the plan covers the geometry: each
// region inside the scratch, each kernel's shared memory large enough.
extern "C" int mxt_box_nms(const void* boxes, const void* ids,
                           const void* n_valid, void* scratch, void* keep,
                           int b, int n, int limit, int blocks, int scan_smem,
                           int walk_smem, int cached,
                           const long long* offsets, long long scratch_bytes,
                           float thresh, void* stream) {
  if (b <= 0 || n <= 0 || limit <= 0 || limit > n || b > 65535 ||
      blocks <= 0 || blocks > 65535 || offsets == nullptr ||
      (reinterpret_cast<uintptr_t>(boxes) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  const int words = (limit + kTile - 1) / kTile;
  const int64_t rows = (int64_t)b * limit, cap = limit / 2 + 1;
  const int64_t need[8] = {rows * 16,   rows * 4,    rows * 4,
                           b * cap * 8, b * cap * 8, (int64_t)b * 2 * 4,
                           (int64_t)b * blocks * words * 8, rows * 16};
  void* at[8];
  for (int r = 0; r < 8; ++r) {
    at[r] = nullptr;
    if (r >= 6 && offsets[r] == -1) continue;  // in shared memory
    if (offsets[r] < 0 || offsets[r] % 16 != 0 ||
        offsets[r] + need[r] > scratch_bytes)
      return cudaErrorInvalidValue;
    at[r] = static_cast<char*>(scratch) + offsets[r];
  }
  const bool removed_in_smem = at[6] == nullptr;
  const bool sort_in_smem = at[7] == nullptr;
  if (scan_smem < kScanSmemFixed + (sort_in_smem ? 16LL * limit : 0) ||
      walk_smem < kWalkSmemFixed +
                      (removed_in_smem ? align16((int64_t)words * 8) : 0) +
                      (cached ? 20LL * limit : 0))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* sbox = static_cast<float4*>(at[0]);
  auto* sarea = static_cast<float*>(at[1]);
  auto* order = static_cast<int*>(at[2]);
  auto* pairs = static_cast<int2*>(at[3]);
  auto* lists = static_cast<int2*>(at[4]);
  auto* counts = static_cast<int*>(at[5]);
  cudaError_t err;
  if ((err = allow_smem((const void*)nms_scan_kernel, scan_smem)) !=
      cudaSuccess)
    return err;
  nms_scan_kernel<<<b, kScanThreads, scan_smem, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(ids),
      static_cast<const int*>(n_valid), sbox, sarea, order, pairs, lists,
      counts, static_cast<uint8_t*>(keep), static_cast<unsigned*>(at[7]), n,
      limit, (int)cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem((const void*)nms_walk_kernel, walk_smem)) !=
      cudaSuccess)
    return err;
  nms_walk_kernel<<<dim3(blocks, b), kWalkThreads, walk_smem, st>>>(
      sbox, sarea, order, lists, counts, static_cast<uint8_t*>(keep),
      static_cast<unsigned long long*>(at[6]), n, limit, (int)cap, words,
      cached ? 1 : 0, thresh);
  return cudaGetLastError();
}

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
