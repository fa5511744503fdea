// The concat-class step (ops/concat_bool.py::boolean_concat_step) on the
// card: two kernels around K4's row sort, which stays as it is.
//
// Replaces no TPU kernel: the JAX package runs this step as plain XLA
// (concat_layout, decode_blocks_pow2, the run-length marks), and the port
// ran it as a chain of some 150-220 torch ops a class chunk, one host
// dispatch each, around K4. A chunk is n queries of one total-block class
// SB; each query's live lists' blocks are laid into SB slots of 128 lanes
// in list order, decoded, sorted once per row (K4, run = 128) and reduced
// by run length.
//
// Entry 1, tpi_concat_decode: reads each query's (idx, found, k_valid)
// through `rows` (the batch's class order, so no gather and no upload per
// chunk), lays its blocks into the slots and decodes every 128-lane block
// (decode.cuh's warp scan), writing flat (n, SB * 128) u32 with 0xFFFFFFFF
// past a block's count and in unused slots, and per query meta (4, n):
// n_valid (lanes that hold postings), k_valid, any_missing (a required term
// is absent) and ff_all (every live list ends in a genuine 0xFFFFFFFF, which
// the sorted row cannot tell from the fill). The grid is (query, range of
// kSlots slots), so a single of 78k blocks fills the card as a chunk of 256
// queries does. Bound: bytes, one arena row read and 512 bytes written per
// slot; an unused slot is only written.
//
// Entry 2, tpi_concat_compact: from the sorted rows and the meta, keep
//   AND: first of its run, the run reaches k_valid, not the fill, and no
//        required term is absent;
//   OR:  first of its run and below n_valid,
// and compact the kept lanes stably: oc (AND: plus ff_all) and the row of
// kept lanes then 0xFFFFFFFF. Sorted lanes at or past n_valid are all fill,
// so neither pass reads them. A row is cut into tiles of up to kMarkTile
// lanes over many CTAs (8 rows of 2^20 lanes are 4,096 CTAs, 256 rows of
// 2^12 are 512), in three launches: each tile counts its kept lanes, one CTA
// a row scans the tile counts, and each tile writes its kept lanes at its
// offset and the fill over its own lanes past the row's count. K4's
// compaction takes one CTA a row, which the set operations' many short rows
// fill, and 8 or 1 long rows do not. Page form (obuf): only the first
// W = min(S, P * K) lanes are compacted, into row rows[i] of the batch's
// (Q, P + 1) buffer: the first P values (0xFFFFFFFF past the kept ones up
// to min(W, P), 0 after), then the true count of the whole row. Bound:
// bytes, two reads of the valid lanes and one write of the row.
#include <cuda_runtime.h>

#include <cstdint>

#include "decode.cuh"

namespace {

constexpr uint32_t kFill = 0xFFFFFFFFu;
constexpr int64_t kMaxGrid = 0x7FFFFFFF;
constexpr int kMaxK = 4096;       // terms a query may have (shared memory)

// ---------------------------------------------------------------------------
// entry 1: layout and decode

constexpr int kDecodeWarps = 8;
constexpr int kSlots = 32;        // slots (128-lane blocks) one CTA lays out

// One arena row (header, anchor, packed deltas) decoded by one warp straight
// from device memory: lane `lane` receives values 4*lane .. 4*lane+3. Words
// at or past `stride` read as zero, as in ops/decode.py. `row` is 8-byte
// aligned and `stride` even, so a pair of words starting at an even word is
// inside the row exactly when its first word is.
__device__ __forceinline__ void decode_block_global(const uint32_t* row,
                                                    int stride, int lane,
                                                    uint32_t v[4]) {
  const uint32_t cls = (row[0] & 0xFFu) >> 3;
  uint32_t d0 = 0u, d1 = 0u, d2 = 0u, d3 = 0u;
  if (cls == 1u) {
    const int w = 2 + lane;
    const uint32_t x = w < stride ? row[w] : 0u;
    d0 = x & 0xFFu;
    d1 = (x >> 8) & 0xFFu;
    d2 = (x >> 16) & 0xFFu;
    d3 = x >> 24;
  } else if (cls == 2u) {
    const int w = 2 + 2 * lane;
    const uint2 x = w < stride ? *reinterpret_cast<const uint2*>(row + w)
                               : make_uint2(0u, 0u);
    d0 = x.x & 0xFFFFu;
    d1 = x.x >> 16;
    d2 = x.y & 0xFFFFu;
    d3 = x.y >> 16;
  } else if (cls == 4u) {
    const int w = 2 + 4 * lane;
    const uint2 lo = w < stride ? *reinterpret_cast<const uint2*>(row + w)
                                : make_uint2(0u, 0u);
    const uint2 hi = w + 2 < stride
                         ? *reinterpret_cast<const uint2*>(row + w + 2)
                         : make_uint2(0u, 0u);
    d0 = lo.x;
    d1 = lo.y;
    d2 = hi.x;
    d3 = hi.y;
  }
  tpi::scan_deltas(row[1], d0, d1, d2, d3, lane, v);
}

// Per-term tables of one query in dynamic shared memory: cum (K + 1) block
// prefix sums, cnt and tbs (K) of the live terms (0 elsewhere), then K flag
// bytes each for missing and has_ff.
struct Terms {
  int64_t* cum;
  int64_t* cnt;
  int64_t* tbs;
  uint8_t* missing;
  uint8_t* has_ff;
};

__device__ __forceinline__ Terms terms_at(unsigned char* smem, int K) {
  Terms t;
  t.cum = reinterpret_cast<int64_t*>(smem);
  t.cnt = t.cum + K + 1;
  t.tbs = t.cnt + K;
  t.missing = reinterpret_cast<uint8_t*>(t.tbs + K);
  t.has_ff = t.missing + K;
  return t;
}

// The term that owns slot s < cum[K]: the largest j < K with cum[j] <= s.
__device__ __forceinline__ int owner(const int64_t* cum, int K, int64_t s) {
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cum[mid] <= s) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// One CTA per (chunk row i, range of kSlots slots). The CTA of range 0 also
// writes row i's meta: (4, n) int32, rows n_valid, k_valid, any_missing,
// ff_all.
__global__ void __launch_bounds__(kDecodeWarps * 32) concat_decode_kernel(
    const uint32_t* __restrict__ blocks, int stride,
    const int32_t* __restrict__ term_block_start,
    const int32_t* __restrict__ counts, const int64_t* __restrict__ idx,
    const uint8_t* __restrict__ found, const int32_t* __restrict__ k_valid,
    int K, const int32_t* __restrict__ rows, int64_t n, int64_t SB,
    int64_t ranges, uint32_t* __restrict__ flat, int32_t* __restrict__ meta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Terms t = terms_at(smem, K);
  const int64_t i = blockIdx.x / ranges;
  const int64_t range = blockIdx.x - i * ranges;
  const int64_t q = rows[i];
  const int kv = k_valid[q];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const bool f = found[q * K + k] != 0;
    const bool live = f && k < kv;
    const int64_t term = live ? idx[q * K + k] : 0;
    t.cnt[k] = live ? counts[term] : 0;
    t.tbs[k] = live ? term_block_start[term] : 0;
    t.missing[k] = k < kv && !f;
    t.has_ff[k] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t c = 0;
    t.cum[0] = 0;
    for (int k = 0; k < K; ++k) {
      c += (t.cnt[k] + tpi::kBlock - 1) / tpi::kBlock;
      t.cum[k + 1] = c;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t used = t.cum[K];
  const int64_t s_end = min(SB, (range + 1) * kSlots);
  uint32_t* frow = flat + i * SB * tpi::kBlock;
  for (int64_t s = range * kSlots + warp; s < s_end; s += kDecodeWarps) {
    uint4 out = make_uint4(kFill, kFill, kFill, kFill);
    if (s < used) {  // uniform across the warp
      const int j = owner(t.cum, K, s);
      const int64_t bit = s - t.cum[j];
      uint32_t v[4];
      decode_block_global(blocks + (t.tbs[j] + bit) * stride, stride, lane,
                          v);
      const int64_t vl = t.cnt[j] - bit * tpi::kBlock;  // >= 1 here
      const int64_t l0 = 4 * lane;
      out.x = l0 < vl ? v[0] : kFill;
      out.y = l0 + 1 < vl ? v[1] : kFill;
      out.z = l0 + 2 < vl ? v[2] : kFill;
      out.w = l0 + 3 < vl ? v[3] : kFill;
    }
    reinterpret_cast<uint4*>(frow + s * tpi::kBlock)[lane] = out;
  }
  if (range != 0) return;  // the whole CTA
  // each live list's last posting, decoded again from its last block
  for (int j = warp; j < K; j += kDecodeWarps) {
    if (t.cnt[j] == 0) continue;  // uniform across the warp
    const int64_t nb = t.cum[j + 1] - t.cum[j];
    uint32_t v[4];
    decode_block_global(blocks + (t.tbs[j] + nb - 1) * stride, stride, lane,
                        v);
    const int last = static_cast<int>((t.cnt[j] - 1) % tpi::kBlock);
    if (lane == last >> 2) {
      const int e = last & 3;
      const uint32_t x = e == 0 ? v[0] : e == 1 ? v[1] : e == 2 ? v[2] : v[3];
      t.has_ff[j] = x == kFill;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t n_valid = 0;
    bool missing = false, any_live = false, all_ff = true;
    for (int k = 0; k < K; ++k) {
      const int64_t room = (SB - t.cum[k]) * tpi::kBlock;
      const int64_t lanes = t.cnt[k] < room ? t.cnt[k] : room;
      const bool live = k < kv && !t.missing[k];
      n_valid += lanes > 0 ? lanes : 0;
      missing |= t.missing[k] != 0;
      any_live |= live;
      all_ff &= t.has_ff[k] != 0 || !live;
    }
    meta[i] = static_cast<int32_t>(n_valid);
    meta[n + i] = kv;
    meta[2 * n + i] = missing;
    meta[3 * n + i] = all_ff && kv > 0 && any_live && !missing;
  }
}

// ---------------------------------------------------------------------------
// entry 2: run-length marks and the compaction over tiles

constexpr int kMarkWarps = 8;
constexpr int kMarkRun = 8;  // 32-lane groups a warp holds
constexpr int kMarkTile = kMarkWarps * 32 * kMarkRun;
constexpr int kScanThreads = 1024;

struct RowKeep {
  const uint32_t* row;  // the sorted row
  int64_t lim;          // lanes below it may be kept: min(n_valid, S[, W])
  int64_t S;
  int kv;
  bool is_and;
  bool none;            // AND with k_valid 0, k_valid > K or a missing term
};

__device__ __forceinline__ RowKeep row_keep(const uint32_t* svals, int64_t S,
                                            const int32_t* meta, int64_t n,
                                            int64_t i, int K, int is_and) {
  RowKeep r;
  r.row = svals + i * S;
  r.S = S;
  r.lim = min(static_cast<int64_t>(meta[i]), S);
  r.kv = meta[n + i];
  r.is_and = is_and != 0;
  r.none = r.is_and && (r.kv <= 0 || r.kv > K || meta[2 * n + i] != 0);
  return r;
}

// Lane c (< r.lim) with value v: kept? Lanes below n_valid are real
// postings, so for AND the fill test is a genuine 0xFFFFFFFF, which the
// sorted row cannot tell from the fill (the meta's ff_all counts it).
__device__ __forceinline__ bool keep_lane(const RowKeep& r, int64_t c,
                                          uint32_t v) {
  if (c > 0 && r.row[c - 1] == v) return false;  // not first of its run
  if (!r.is_and) return true;
  if (r.none || v == kFill) return false;
  const int64_t e = c + r.kv - 1;
  return (e < r.S ? r.row[e] : kFill) == v;
}

// One CTA per (row i, tile t): the tile's kept lanes into cnt[i, t]
// (cnt is (n, tiles + 1)).
__global__ void __launch_bounds__(kMarkWarps * 32) concat_count_kernel(
    const uint32_t* __restrict__ svals, int64_t S,
    const int32_t* __restrict__ meta, int64_t n, int K, int is_and, int tile,
    int64_t tiles, int32_t* __restrict__ cnt) {
  __shared__ int warp_sum[kMarkWarps];
  const int64_t i = blockIdx.x / tiles;
  const int64_t tt = blockIdx.x - i * tiles;
  const RowKeep r = row_keep(svals, S, meta, n, i, K, is_and);
  const int64_t c0 = tt * tile;
  const int64_t c1 = min(c0 + tile, r.lim);
  int k = 0;
  if (!r.none) {
    for (int64_t c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      k += keep_lane(r, c, r.row[c]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    k += __shfl_xor_sync(0xFFFFFFFFu, k, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      total += warp_sum[w];
    }
    cnt[i * (tiles + 1) + tt] = total;
  }
}

// One CTA per row: cnt[i, :tiles] becomes its exclusive prefix sums and
// cnt[i, tiles] the row's kept lanes; oc = that, plus ff_all for AND, goes
// to oc[i] (full form) or to column P of obuf row rows[i] (page form).
__global__ void __launch_bounds__(kScanThreads) concat_scan_kernel(
    int32_t* __restrict__ cnt, int64_t tiles,
    const int32_t* __restrict__ meta, int64_t n, int is_and,
    int32_t* __restrict__ oc, const int32_t* __restrict__ rows,
    int32_t* __restrict__ obuf, int P) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int64_t i = blockIdx.x;
  int32_t* c = cnt + i * (tiles + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t b = 0; b < tiles; b += blockDim.x) {  // uniform
    const int64_t e = b + threadIdx.x;
    const int x = e < tiles ? c[e] : 0;
    int inc = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, off);
      if (lane >= off) inc += y;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    int before = carry, total = carry;
    for (int w = 0; w < n_warps; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    if (e < tiles) c[e] = before + inc - x;
    __syncthreads();  // every thread has read carry and warp_sum
    if (threadIdx.x == 0) carry = total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    c[tiles] = carry;
    const int32_t count = carry + (is_and ? meta[3 * n + i] : 0);
    if (obuf != nullptr) {
      obuf[static_cast<int64_t>(rows[i]) * (P + 1) + P] = count;
    } else {
      oc[i] = count;
    }
  }
}

// One CTA per (row i, tile t): the tile's kept lanes at their places, then
// the fill over the tile's own output lanes at or past the row's count.
// Warp w holds kMarkRun groups of 32 consecutive lanes; a ballot places a
// kept lane in its group, a scan of the warps' totals in the tile, cnt's
// prefix in the row. Page form (obuf): lanes at or past W are not kept,
// values go to obuf row rows[i] below Pw = min(W, P), and the tile holding
// lane W - 1 writes the rest of the page: 0xFFFFFFFF up to Pw, 0 to P.
__global__ void __launch_bounds__(kMarkWarps * 32) concat_scatter_kernel(
    const uint32_t* __restrict__ svals, int64_t S,
    const int32_t* __restrict__ meta, int64_t n, int K, int is_and, int tile,
    int64_t tiles, int64_t grid_tiles, const int32_t* __restrict__ cnt,
    uint32_t* __restrict__ out, const int32_t* __restrict__ rows,
    uint32_t* __restrict__ obuf, int64_t W, int P) {
  __shared__ int warp_total[kMarkWarps];
  const int64_t i = blockIdx.x / grid_tiles;
  const int64_t tt = blockIdx.x - i * grid_tiles;
  RowKeep r = row_keep(svals, S, meta, n, i, K, is_and);
  const bool page = obuf != nullptr;
  if (page) r.lim = min(r.lim, W);
  const int32_t* c = cnt + i * (tiles + 1);
  const int64_t t0 = tt * tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  const int64_t base = t0 + static_cast<int64_t>(warp) * 32 * kMarkRun + lane;
  uint32_t v[kMarkRun];
  int pre[kMarkRun];  // kept lanes of this warp before mine, or -1
  int wsum = 0;
#pragma unroll
  for (int e = 0; e < kMarkRun; ++e) {
    const int64_t cl = base + e * 32;
    const bool in = !r.none && cl < r.lim;
    v[e] = in ? r.row[cl] : 0u;
    const bool k = in && keep_lane(r, cl, v[e]);
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, k);
    pre[e] = k ? wsum + __popc(ballot & below) : -1;
    wsum += __popc(ballot);
  }
  if (lane == 0) warp_total[warp] = wsum;
  __syncthreads();
  int before = 0, in_tile = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int x = warp_total[w];
    before += w < warp ? x : 0;
    in_tile += x;
  }
  const int64_t at = c[tt] + before;
  if (!page) {
    uint32_t* orow = out + i * S;
#pragma unroll
    for (int e = 0; e < kMarkRun; ++e) {
      if (pre[e] >= 0) orow[at + pre[e]] = v[e];
    }
    const int64_t total = c[tiles];
    const int64_t t1 = min(t0 + tile, S);
    for (int64_t cl = max(t0, total) + threadIdx.x; cl < t1;
         cl += blockDim.x) {
      orow[cl] = kFill;
    }
    return;
  }
  const int64_t pw = min(W, static_cast<int64_t>(P));
  uint32_t* prow = obuf + static_cast<int64_t>(rows[i]) * (P + 1);
#pragma unroll
  for (int e = 0; e < kMarkRun; ++e) {
    if (pre[e] >= 0 && at + pre[e] < pw) prow[at + pre[e]] = v[e];
  }
  if (tt == grid_tiles - 1) {  // the tile that holds lane W - 1
    const int64_t kept_w = c[tt] + in_tile;
    for (int64_t j = threadIdx.x; j < P; j += blockDim.x) {
      if (j >= kept_w || j >= pw) prow[j] = j < pw ? kFill : 0u;
    }
  }
}

}  // namespace

// blocks (rows, stride) u32, stride a multiple of 4 and the base 16-byte
// aligned; term_block_start, counts (N,) int32; idx (Q, K) int64, found
// (Q, K) bytes, k_valid (Q,) int32 of a resolved batch; rows (n,) int32
// indexes into it. flat (n, SB * 128) and meta (4, n) as the header says.
// SB * 128 < 2^30. Returns the first CUDA error, or 0.
extern "C" int tpi_concat_decode(const void* blocks, int stride,
                                 const void* term_block_start,
                                 const void* counts, const void* idx,
                                 const void* found, const void* k_valid,
                                 int K, const void* rows, int64_t n,
                                 int64_t SB, void* flat, void* meta,
                                 void* stream) {
  if (n == 0) return 0;
  if (K < 1 || K > kMaxK || SB < 1 || stride < 4 || stride % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ranges = (SB + kSlots - 1) / kSlots;
  if (ranges > kMaxGrid / n) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (3 * K + 1) * static_cast<int>(sizeof(int64_t)) + 2 * K;
  static int allowed_smem = 48 * 1024;
  if (smem > allowed_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        concat_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_smem = smem;
  }
  concat_decode_kernel<<<static_cast<unsigned>(n * ranges), kDecodeWarps * 32,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), stride,
      static_cast<const int32_t*>(term_block_start),
      static_cast<const int32_t*>(counts), static_cast<const int64_t*>(idx),
      static_cast<const uint8_t*>(found), static_cast<const int32_t*>(k_valid),
      K, static_cast<const int32_t*>(rows), n, SB, ranges,
      static_cast<uint32_t*>(flat), static_cast<int32_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

// svals (n, S) u32 sorted rows, meta (4, n) from tpi_concat_decode, K the
// queries' padded width, is_and 1 for AND and 0 for OR. cnt: scratch of
// n * (tiles + 1) int32, tiles = ceil(S / kMarkTile). Full form (obuf
// null): out (n, S) u32 and oc (n,) int32. Page form: obuf (Q, P + 1)
// int32 written at rows rows[i] (n,), W = min(S, P * K) >= 1; out and oc
// are not written. Returns the first CUDA error, or 0.
extern "C" int tpi_concat_compact(const void* svals, int64_t S,
                                  const void* meta, int64_t n, int K,
                                  int is_and, void* cnt, void* out, void* oc,
                                  const void* rows, void* obuf, int64_t W,
                                  int P, void* stream) {
  if (n == 0 || S == 0) return 0;
  const bool page = obuf != nullptr;
  if (page && (W < 1 || W > S || P < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (S + kMarkTile - 1) / kMarkTile;
  // a row shorter than a tile takes a CTA of fewer warps
  const int64_t warps64 = (S + 32 * kMarkRun - 1) / (32 * kMarkRun);
  const int warps = static_cast<int>(warps64 < kMarkWarps ? warps64
                                                          : kMarkWarps);
  const int tile = warps * 32 * kMarkRun;  // == kMarkTile when tiles > 1
  const int64_t grid_tiles = page ? (W + tile - 1) / tile : tiles;
  if (tiles > kMaxGrid / n) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* sv = static_cast<const uint32_t*>(svals);
  const auto* mt = static_cast<const int32_t*>(meta);
  auto* ct = static_cast<int32_t*>(cnt);
  concat_count_kernel<<<static_cast<unsigned>(n * tiles), warps * 32, 0, st>>>(
      sv, S, mt, n, K, is_and, tile, tiles, ct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t scan_threads64 = (tiles + 31) / 32 * 32;
  const int scan_threads = static_cast<int>(
      scan_threads64 < kScanThreads ? scan_threads64 : kScanThreads);
  concat_scan_kernel<<<static_cast<unsigned>(n), scan_threads, 0, st>>>(
      ct, tiles, mt, n, is_and, static_cast<int32_t*>(oc),
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(obuf), P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  concat_scatter_kernel<<<static_cast<unsigned>(n * grid_tiles), warps * 32,
                          0, st>>>(
      sv, S, mt, n, K, is_and, tile, tiles, grid_tiles, ct,
      static_cast<uint32_t*>(out), static_cast<const int32_t*>(rows),
      static_cast<uint32_t*>(obuf), W, P);
  return static_cast<int>(cudaGetLastError());
}
