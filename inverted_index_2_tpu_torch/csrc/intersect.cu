// Kernel K3: batched AND of K sorted uint32 lists per query.
//
// Replaces inverted_index_2_tpu/ops/pallas_bool.py::intersect_pallas, the
// TPU twin of ops/setops.py::intersect_many, which is the AND of the delta
// tier's padded dual step (models/steps.py boolean_step_dual). Inputs:
// lists (Q, K, L) with row j of query q valid in [0, counts[q, j]) and
// garbage beyond, k_valid (Q,) lists present. Output: the base list's
// (list 0) values that are members of lists 1 .. k_valid-1, ascending at the
// front of a (Q, L) row, 0xFFFFFFFF to the end of the row, and the count.
// The plain version has two regimes that differ on a row with k_valid = 0:
// its broadcast regime (small L) keeps the base's valid prefix, its sort
// regime gives an empty row. `keep_base` picks between them, and the wrapper
// sets it as the plain version would choose at this L.
//
// The TPU kernel compared every base value with every probe value (O(L^2)
// VPU broadcasts in VMEM) and left the compaction to a jnp.sort outside.
// Neither carries over. Design, one CTA per query:
//   * the base's valid prefix goes in tiles of kTile values; each thread
//     holds kRun consecutive base values in registers, with a keep bit each;
//   * for each probe list j, the CTA stages the list's valid prefix in
//     shared memory when it fits (kStage values), else searches it in
//     global memory; each thread binary-searches its values in order,
//     starting each search at the previous one's position (its values
//     ascend, the list is sorted unique), compared as uint32; a miss clears
//     the keep bit, and the CTA stops early once no bit in the tile is set;
//   * a block-wide scan of the per-thread keep counts gives each thread its
//     output position; kept values are written in base order, so ascending.
// No lane past a list's count is read, and a genuine 0xFFFFFFFF member
// counts like any other value (validity comes from counts, not the fill).
//
// Bound: device-memory bytes. The valid prefixes of lists 0 .. k_valid-1
// are read (a staged list once per base tile; one tile covers every base
// up to kTile values) and the whole output row and the count are written.
// The compares, log2(count) per base value and probe list, run on shared
// memory or L1.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                   // base values a thread holds
constexpr int kTile = kThreads * kRun;     // base values per tile
constexpr int kStage = 8192;               // probe values staged (32 KiB)
constexpr uint32_t kFill = 0xFFFFFFFFu;

// first position in a[lo, hi) whose value is >= x (uint32 order)
__device__ __forceinline__ int lower_bound(const uint32_t* a, int lo, int hi,
                                           uint32_t x) {
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

__global__ void __launch_bounds__(kThreads) intersect_kernel(
    const uint32_t* __restrict__ lists, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ k_valid, int K, int L, int keep_base,
    uint32_t* __restrict__ out, int32_t* __restrict__ out_counts) {
  __shared__ uint32_t stage[kStage];
  __shared__ int warp_total[kThreads / 32];
  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* row = lists + q * K * static_cast<int64_t>(L);
  const int32_t* cnt = counts + q * K;
  const int kv = min(k_valid[q], K);
  // with no list present no probe runs, so the whole base prefix is kept
  const int n0 = (kv > 0 || keep_base) ? min(max(cnt[0], 0), L) : 0;
  uint32_t* orow = out + q * static_cast<int64_t>(L);
  int written = 0;

  for (int t0 = 0; t0 < n0; t0 += kTile) {  // uniform across the CTA
    const int first = t0 + threadIdx.x * kRun;
    uint32_t v[kRun];
    uint32_t keep = 0;
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      v[e] = 0;
      if (first + e < n0) {
        v[e] = row[first + e];
        keep |= 1u << e;
      }
    }
    for (int j = 1; j < kv; ++j) {
      // also the barrier before the stage buffer is overwritten
      if (!__syncthreads_or(keep != 0)) break;
      const int nj = min(max(cnt[j], 0), L);
      const uint32_t* src = row + static_cast<int64_t>(j) * L;
      if (nj <= kStage) {  // nj is the same for every thread
        for (int i = threadIdx.x; i < nj; i += kThreads) stage[i] = src[i];
        __syncthreads();
        src = stage;
      }
      int lo = 0;
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if (keep & (1u << e)) {
          lo = lower_bound(src, lo, nj, v[e]);
          if (lo >= nj || src[lo] != v[e]) keep &= ~(1u << e);
        }
      }
    }

    // block-wide exclusive scan of the keep counts
    const int c = __popc(keep);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int x = warp_total[w];
      before += w < warp ? x : 0;
      total += x;
    }
    int pos = written + before + incl - c;
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (keep & (1u << e)) orow[pos++] = v[e];
    }
    written += total;
    __syncthreads();  // warp_total and stage are reused by the next tile
  }

  for (int i = written + threadIdx.x; i < L; i += kThreads) orow[i] = kFill;
  if (threadIdx.x == 0) out_counts[q] = written;
}

}  // namespace

// lists (Q, K, L), counts (Q, K), k_valid (Q,) int32, all contiguous; out
// (Q, L) and out_counts (Q,) fresh allocations. keep_base != 0: a row with
// k_valid = 0 keeps its base's valid prefix, else it is empty. Returns
// cudaGetLastError() after the launch.
extern "C" int tpi_intersect(const void* lists, const void* counts,
                             const void* k_valid, int Q, int K, int L,
                             int keep_base, void* out, void* out_counts,
                             void* stream) {
  if (Q == 0) return 0;
  intersect_kernel<<<static_cast<unsigned>(Q), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lists), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(k_valid), K, L, keep_base,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(out_counts));
  return static_cast<int>(cudaGetLastError());
}
