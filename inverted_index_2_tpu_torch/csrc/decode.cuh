// Posting-block decode for one warp: the device function shared by kernel
// K1 (decode_postings.cu) and kernel K2 (fused_and.cu).
//
// Arena row = one 128-value block of the codec/packing.py layout with
// power-of-two byte widths: [header = b | n_blk << 8, anchor, packed ...],
// b in {0, 8, 16, 32}. Delta j is byte j (b = 8), half j (b = 16) or word j
// (b = 32) of the packed words; v[0] = anchor, v[j+1] = v[j] + d[j] + 1,
// all mod 2^32. The TPU decoder interleaved byte planes with a permutation
// matmul on the MXU; here each lane pulls its four deltas out with shifts
// and masks, and the 127-step prefix sum is a warp scan on uint32, which
// wraps mod 2^32 as the codec does. Any other class decodes as zero deltas
// and words past the row read as zero, as in ops/decode.py.
//
// Rows come in from device memory through 16-byte cp.async copies into a
// ring of rows in shared memory (stage_row, decode_rows_staged), so that a
// row's header, anchor and packed words arrive together and the next rows'
// latency hides behind the current row's scan.
#pragma once

#include <cuda_pipeline_primitives.h>

#include <cstdint>

namespace tpi {

constexpr int kBlock = 128;

// Values of one block from its anchor and the four deltas each lane holds
// (deltas 4*lane .. 4*lane+3): the 127-step prefix sum as a warp scan on
// uint32. All 32 lanes call this together.
static __device__ __forceinline__ void scan_deltas(uint32_t anchor,
                                                   uint32_t d0, uint32_t d1,
                                                   uint32_t d2, uint32_t d3,
                                                   int lane, uint32_t v[4]) {
  const uint32_t s0 = d0 + 1u, s1 = d1 + 1u, s2 = d2 + 1u;
  const uint32_t total = s0 + s1 + s2 + (d3 + 1u);
  // inclusive warp scan of the per-lane step totals
  uint32_t inc = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, off);
    if (lane >= off) inc += y;
  }
  v[0] = anchor + (inc - total);
  v[1] = v[0] + s0;
  v[2] = v[1] + s1;
  v[3] = v[2] + s2;
}

// The widest arena row: header, anchor and 128 deltas of 4 bytes, rounded up
// to a 16-byte multiple.
constexpr int kMaxRowWords = 132;

// One block, staged in shared memory, decoded by one warp: all 32 lanes call
// this together and lane `lane` receives values 4*lane .. 4*lane+3 of the
// block in v[0..3]. `row` is 8-byte aligned and holds at least kMaxRowWords
// words, the words past the arena's stride zero, so no word needs a bounds
// test and words past the row read as zero, as in ops/decode.py.
static __device__ __forceinline__ void decode_block_warp_staged(
    const uint32_t* row, int lane, uint32_t v[4]) {
  const uint32_t cls = (row[0] & 0xFFu) >> 3;
  uint32_t d0 = 0u, d1 = 0u, d2 = 0u, d3 = 0u;
  if (cls == 1u) {
    const uint32_t w = row[2 + lane];
    d0 = w & 0xFFu;
    d1 = (w >> 8) & 0xFFu;
    d2 = (w >> 16) & 0xFFu;
    d3 = w >> 24;
  } else if (cls == 2u) {
    const uint2 w = reinterpret_cast<const uint2*>(row + 2)[lane];
    d0 = w.x & 0xFFFFu;
    d1 = w.x >> 16;
    d2 = w.y & 0xFFFFu;
    d3 = w.y >> 16;
  } else if (cls == 4u) {
    const uint2 lo = reinterpret_cast<const uint2*>(row + 2)[2 * lane];
    const uint2 hi = reinterpret_cast<const uint2*>(row + 2)[2 * lane + 1];
    d0 = lo.x;
    d1 = lo.y;
    d2 = hi.x;
    d3 = hi.y;
  }
  scan_deltas(row[1], d0, d1, d2, d3, lane, v);
}

// Lane's share of the 16-byte copies of arena row `src` (stride words, a
// multiple of 4, 16-byte aligned) into the staged row `dst`; the caller
// commits.
static __device__ __forceinline__ void stage_row(uint32_t* dst,
                                                 const uint32_t* src,
                                                 int stride, int lane) {
  for (int c = lane; c * 4 < stride; c += 32) {
    __pipeline_memcpy_async(dst + c * 4, src + c * 4, 16);
  }
}

// One warp decodes m arena rows, row k at src(k), through its own ring of
// kStages staged rows of `pitch` words (the words past the stride zero), and
// hands each row's values to use(k, v). kStages - 1 rows are in flight while
// row k decodes. Every iteration commits one group (an empty one past the
// last row), so "all but the newest kStages - 1 groups" is always "row k has
// arrived". All 32 lanes call this together; no copy is pending on return.
template <int kStages, class Src, class Use>
static __device__ __forceinline__ void decode_rows_staged(
    uint32_t* ring, int pitch, int stride, int lane, int m, Src src, Use use) {
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < m) stage_row(ring + k * pitch, src(k), stride, lane);
    __pipeline_commit();
  }
  for (int k = 0; k < m; ++k) {
    const int ahead = k + kStages - 1;
    if (ahead < m) {
      stage_row(ring + (ahead % kStages) * pitch, src(ahead), stride, lane);
    }
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);
    __syncwarp();  // every lane's copies of row k are visible
    uint32_t v[4];
    decode_block_warp_staged(ring + (k % kStages) * pitch, lane, v);
    use(k, v);
    __syncwarp();  // row k's slot is free for the copy of row k + kStages
  }
}

}  // namespace tpi
