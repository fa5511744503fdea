// Searches over sorted uint32 sequences, shared by kernel K2 (fused_and.cu)
// and kernel K3 (intersect.cu). Everything compares as uint32.
#pragma once

#include <cstdint>

namespace tpi {

// first position in a[lo, hi) whose value is >= x; `a` may lie in shared or
// in global memory
static __device__ __forceinline__ int lower_bound(const uint32_t* a, int lo,
                                                  int hi, uint32_t x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Two such boundaries of one sequence in global memory, found by a whole
// warp together: *p1 is the first i in [0, n) with a[i * pitch] >= x1
// (kUpper1: > x1), n if there is none, and *p2 the same for x2. Each round
// the 32 lanes read 32 evenly spaced elements of each remaining range at
// once and a ballot keeps one 32nd of it, so a list of 32768 values costs
// three dependent reads, not fifteen, and the two searches share them. All
// 32 lanes call this together with the same arguments.
template <bool kUpper1, bool kUpper2>
static __device__ __forceinline__ void warp_bounds(const uint32_t* a,
                                                   int64_t pitch, int n,
                                                   uint32_t x1, uint32_t x2,
                                                   int lane, int* p1,
                                                   int* p2) {
  int lo1 = 0, hi1 = n, lo2 = 0, hi2 = n;
  while (lo1 < hi1 || lo2 < hi2) {  // uniform across the warp
    const int step1 = (hi1 - lo1 + 31) >> 5;
    const int step2 = (hi2 - lo2 + 31) >> 5;
    const int i1 = lo1 + lane * step1;
    const int i2 = lo2 + lane * step2;
    // both reads start before either is used
    const uint32_t y1 = i1 < hi1 ? __ldg(a + i1 * pitch) : 0u;
    const uint32_t y2 = i2 < hi2 ? __ldg(a + i2 * pitch) : 0u;
    // the sequence ascends, so "lies before the boundary" holds for a
    // prefix of the lanes
    const int c1 = __popc(__ballot_sync(
        0xFFFFFFFFu, i1 < hi1 && (kUpper1 ? y1 <= x1 : y1 < x1)));
    const int c2 = __popc(__ballot_sync(
        0xFFFFFFFFu, i2 < hi2 && (kUpper2 ? y2 <= x2 : y2 < x2)));
    if (c1 == 0) {
      hi1 = lo1;
    } else {
      hi1 = min(lo1 + c1 * step1, hi1);
      lo1 = lo1 + (c1 - 1) * step1 + 1;
    }
    if (c2 == 0) {
      hi2 = lo2;
    } else {
      hi2 = min(lo2 + c2 * step2, hi2);
      lo2 = lo2 + (c2 - 1) * step2 + 1;
    }
  }
  *p1 = lo1;
  *p2 = lo2;
}

}  // namespace tpi
