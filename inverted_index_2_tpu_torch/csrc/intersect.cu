// Kernel K3: batched AND of K sorted uint32 lists per query.
//
// Replaces inverted_index_2_tpu/ops/pallas_bool.py::intersect_pallas, the
// TPU twin of ops/setops.py::intersect_many, which is the AND of the delta
// tier's padded dual step (models/steps.py boolean_step_dual). Inputs:
// lists (Q, K, L) with row j of query q valid in [0, counts[q, j]) and
// garbage beyond, k_valid (Q,) lists present. Output: the values that are
// members of every present list, ascending at the front of a (Q, L) row,
// 0xFFFFFFFF to the end of the row, and the count. The plain version has two
// regimes that differ on a row with k_valid = 0: its broadcast regime (small
// L) keeps list 0's valid prefix, its sort regime gives an empty row.
// `keep_base` picks between them, and the wrapper sets it as the plain
// version would choose at this L.
//
// The TPU kernel compared every base value with every probe value (O(L^2)
// VPU broadcasts in VMEM) and left the compaction to a jnp.sort outside.
// Neither carries over.
//
// Bound: device-memory bytes (the valid values the AND needs are read once,
// the whole output row is written once). What stands between a kernel and
// that bound on this card is latency, not arithmetic: a binary search is a
// chain of dependent reads, and a design that gives a few threads many
// searches each, one probe list after another, with a copy of the whole
// list in front of each, spends its time waiting. What this design does:
//   * The AND does not depend on which present list is walked, so the base
//     is the SHORTEST present list and the probes follow shortest first: the
//     fewest searches, and the running result empties early. (k_valid = 0
//     stays on list 0, as `keep_base` says.)
//   * The base goes in tiles of kTile values spread over all threads of the
//     CTA (value i of a tile to thread i mod kThreads), so a base of a few
//     hundred values costs each thread one or two searches per probe.
//   * Of a probe list only the window that [tile_min, tile_max] can hit is
//     looked at. The windows are found by one warp per probe, both ends in
//     one search of 32 reads a round (search.cuh warp_bounds).
//   * Windows are copied into a two-slot ring in shared memory with 16-byte
//     cp.async copies, several probes to a slot; the next batch of windows
//     arrives while this one is searched. The first batch is the shortest
//     probe alone, since it most often empties the result: a short one is
//     copied whole, with no search for its window, and the other probes'
//     windows are found, and their copies started, only once the first
//     probe has left a value alive. A window that does not fit a slot, or
//     is far longer than the tile's base, is searched where it lies (global
//     memory or L2): fewer reads than its copy. Rows whose start is not
//     16-byte aligned are copied by words.
//   * Kept values are compacted in base order by ballots and a block scan,
//     which a tile that keeps nothing (most tiles) skips.
//   * The row's fill (most of the bytes) is written as soon as the first
//     reads are asked for, behind them in the memory pipeline and under way
//     while they are waited for: no more than the base's count can be kept,
//     so lanes [count of the base, L) are fill whatever the searches find.
//   * One CTA per query walks the base's tiles in turn and writes the row;
//     with many queries the CTA is small (a typical base is a few hundred
//     values, and more CTAs on an SM hide more of each other's waits). A
//     grid of (query, tile) was tried for the long rows of a ladder re-serve
//     and lost there: with the shortest list as the base, few of a long
//     row's tiles hold any work.
// No lane past a list's count decides anything, and a genuine 0xFFFFFFFF
// member counts like any other value (validity comes from counts, not the
// fill).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "search.cuh"

namespace {

constexpr int kTile = 1024;                // base values per tile
constexpr int kSlot = 2048;                // values in one ring slot (8 KiB)
// threads of a CTA: a typical base of the dual pass is a few hundred values,
// and small CTAs hide more of each other's waits (measured); the long bases
// of a re-serve get a thread per four values
constexpr int kThreadsMany = 128;          // many queries, one CTA each
constexpr int kThreadsFew = 256;
constexpr int kManyQueries = 2048;         // from here on, kThreadsMany
constexpr int kWholeFirst = 1024;          // a first probe copied whole
constexpr int kMaxK = 32;                  // lists per query
// a window this many times the tile's base is searched where it lies
constexpr int kDirectRatio = 32;
constexpr uint32_t kFill = 0xFFFFFFFFu;

struct Window {
  int lo, hi;  // [lo, hi) of the probe list can hold a value of the tile
};

// Slot words that the window takes when staged, and where its copy starts
// in the list: 0 for an empty window, -1 for one searched where it lies.
// `whole`: the window is a short first probe, copied whatever the base.
__device__ __forceinline__ int staged_words(Window w, int n_tile, bool aligned,
                                            bool whole, int* start) {
  const int len = w.hi - w.lo;
  *start = w.lo;
  if (len <= 0) return 0;
  if (!whole && (len > kSlot - 8 || len > n_tile * kDirectRatio)) return -1;
  if (!aligned) return len;
  *start = w.lo & ~3;
  return ((w.hi + 3) & ~3) - *start;
}

// 0xFFFFFFFF into row[from, to), 16 bytes a store where the row allows it
// (`aligned`: the row starts on 16 bytes and `to` is a multiple of 4)
template <int kThreads>
__device__ __forceinline__ void fill_lanes(uint32_t* row, int from, int to,
                                           bool aligned, int tid) {
  if (!aligned) {
    for (int i = from + tid; i < to; i += kThreads) row[i] = kFill;
    return;
  }
  const int head = min((from + 3) & ~3, to);
  for (int i = from + tid; i < head; i += kThreads) row[i] = kFill;
  uint4* r4 = reinterpret_cast<uint4*>(row);
  for (int i = head / 4 + tid; i < to / 4; i += kThreads) {
    r4[i] = make_uint4(kFill, kFill, kFill, kFill);
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads) intersect_kernel(
    const uint32_t* __restrict__ lists, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ k_valid, int K, int L, int keep_base,
    int aligned, uint32_t* __restrict__ out,
    int32_t* __restrict__ out_counts) {
  __shared__ __align__(16) uint32_t ring[2][kSlot];
  __shared__ int s_cnt[kMaxK];      // counts clamped to [0, L]
  __shared__ int s_order[kMaxK];    // present lists, shortest first
  __shared__ Window s_win[kMaxK];   // by position in s_order
  constexpr int kWarps = kThreads / 32;
  constexpr int kRun = kTile / kThreads;  // base values a thread holds
  __shared__ int s_kept[kRun][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q = blockIdx.x;
  const uint32_t* row = lists + q * K * static_cast<int64_t>(L);
  const int kv = min(max(k_valid[q], 0), K);

  if (tid < K) s_cnt[tid] = min(max(counts[q * K + tid], 0), L);
  __syncthreads();
  if (tid < kv) {  // rank by (count, slot): a stable order
    const int c = s_cnt[tid];
    int rank = 0;
    for (int i = 0; i < kv; ++i) {
      const int ci = s_cnt[i];
      rank += (ci < c) || (ci == c && i < tid);
    }
    s_order[rank] = tid;
  }
  __syncthreads();
  // with no list present no probe runs: list 0's prefix is kept or dropped
  const int bj = kv > 0 ? s_order[0] : 0;
  const int n0 = (kv > 0 || keep_base) ? s_cnt[bj] : 0;
  const uint32_t* base = row + static_cast<int64_t>(bj) * L;
  // a short first probe is copied whole: no search before its copy
  const bool whole1 = kv > 1 && s_cnt[s_order[1]] <= kWholeFirst;
  int written = 0;
  uint32_t* dst = out + q * static_cast<int64_t>(L);
  // The fill is written while the first reads are in flight (below). At
  // most n0 values are kept: lanes [n0, L) are filled then and [count, n0)
  // at the end.
  if (n0 == 0) fill_lanes<kThreads>(dst, 0, L, aligned, tid);  // no tile

  for (int t = 0; t * kTile < n0; ++t) {
    const int t0 = t * kTile;
    const int nt = min(kTile, n0 - t0);
    uint32_t v[kRun];
    uint32_t keep = 0;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int i = r * kThreads + tid;
      v[r] = 0;
      if (i < nt) {
        v[r] = base[t0 + i];
        keep |= 1u << r;
      }
    }
    // Probes s_order[b, e) make one batch: their staged windows share a
    // ring slot. Every thread derives the same batches from s_win.
    auto words_of = [&](int o, int* start) {
      return staged_words(s_win[o], nt, aligned, o == 1 && whole1, start);
    };
    auto batch_end = [&](int b, bool single) {
      int used = 0, e = b;
      while (e < kv) {
        int start;
        const int words = words_of(e, &start);
        if (words > 0) {
          if (used + words > kSlot) break;  // never the batch's first probe
          used += words;
        }
        ++e;
        if (single) break;
      }
      return e;
    };
    auto stage = [&](int b, int e, uint32_t* slot) {
      int off = 0;
      for (int o = b; o < e; ++o) {
        int start;
        const int words = words_of(o, &start);
        if (words <= 0) continue;
        const uint32_t* src =
            row + static_cast<int64_t>(s_order[o]) * L + start;
        if (aligned) {
          for (int c = tid; c * 4 < words; c += kThreads) {
            __pipeline_memcpy_async(slot + off + c * 4, src + c * 4, 16);
          }
        } else {
          for (int i = tid; i < words; i += kThreads) slot[off + i] = src[i];
        }
        off += words;
      }
    };
    // windows of probes s_order[from, to), a warp each
    auto find_windows = [&](int from, int to) {
      const uint32_t tmin = __ldg(base + t0);
      const uint32_t tmax = __ldg(base + t0 + nt - 1);
      for (int o = from + warp; o < to; o += kWarps) {
        const int j = s_order[o];
        Window w;
        tpi::warp_bounds<false, true>(
            row + static_cast<int64_t>(j) * L, 1, s_cnt[j], tmin, tmax, lane,
            &w.lo, &w.hi);
        if (lane == 0) s_win[o] = w;
      }
    };

    if (whole1) {
      if (tid == 0) s_win[1] = Window{0, s_cnt[s_order[1]]};
    } else {
      find_windows(1, min(2, kv));
    }
    __syncthreads();
    int b = 1, e = batch_end(1, true), e2 = e, cur = 0;
    int alive = 1;
    if (b < kv) stage(b, e, ring[0]);
    __pipeline_commit();
    // behind the reads in the memory pipeline, not in front of them
    if (t == 0) fill_lanes<kThreads>(dst, n0, L, aligned, tid);
    while (b < kv) {  // uniform across the CTA
      if (b > 1) {  // the batch after this one arrives while this is searched
        e2 = batch_end(e, false);
        if (e < kv) stage(e, e2, ring[cur ^ 1]);
      }
      __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncthreads();  // batch [b, e) has arrived, from every thread
      int off = 0;
      for (int o = b; o < e; ++o) {
        const Window w = s_win[o];
        int start;
        const int words = words_of(o, &start);
        // a[i] is value i of the probe list for i in [w.lo, w.hi)
        const uint32_t* a =
            words > 0 ? ring[cur] + off - start
                      : row + static_cast<int64_t>(s_order[o]) * L;
        if (words > 0) off += words;
        int lo = w.lo;
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          if (keep & (1u << r)) {  // a thread's values ascend with r
            lo = tpi::lower_bound(a, lo, w.hi, v[r]);
            if (lo >= w.hi || a[lo] != v[r]) keep &= ~(1u << r);
          }
        }
      }
      // also the barrier before this slot is staged again
      alive = __syncthreads_or(keep != 0);
      if (!alive) break;
      if (b == 1) {  // the other probes are looked at only for a live result
        find_windows(2, kv);
        __syncthreads();
        e2 = batch_end(e, false);
        if (e < kv) stage(e, e2, ring[1]);
        __pipeline_commit();
      }
      b = e;
      e = e2;
      cur ^= 1;
    }
    __pipeline_wait_prior(0);  // a batch staged ahead of an early exit
    // most tiles keep nothing: no scan, no barrier
    if (!alive) continue;

    // kept values in base order: value i of the tile is (r, thread), i =
    // r * kThreads + thread
    int mine[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, (keep >> r) & 1u);
      if (lane == 0) s_kept[r][warp] = __popc(m);
      mine[r] = __popc(m & ((1u << lane) - 1u));
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      int before = total;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int x = s_kept[r][w];
        before += w < warp ? x : 0;
        total += x;
      }
      if ((keep >> r) & 1u) {
        dst[written + before + mine[r]] = v[r];
      }
    }
    written += total;
    __syncthreads();  // s_kept, s_win and the ring are reused by the next tile
  }

  for (int i = written + tid; i < n0; i += kThreads) dst[i] = kFill;
  if (tid == 0) out_counts[q] = written;
}

}  // namespace

// lists (Q, K, L), counts (Q, K), k_valid (Q,) int32, all contiguous; out
// (Q, L) and out_counts (Q,) fresh allocations. keep_base != 0: a row with
// k_valid = 0 keeps list 0's valid prefix, else it is empty. One CTA per
// query. Returns the first CUDA error, or 0.
extern "C" int tpi_intersect(const void* lists, const void* counts,
                             const void* k_valid, int Q, int K, int L,
                             int keep_base, void* out, void* out_counts,
                             void* stream) {
  if (Q == 0) return 0;
  if (K < 1 || K > kMaxK || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const uint32_t*>(lists);
  const auto* c = static_cast<const int32_t*>(counts);
  const auto* kv = static_cast<const int32_t*>(k_valid);
  auto* o = static_cast<uint32_t*>(out);
  auto* oc = static_cast<int32_t*>(out_counts);
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const int aligned = L % 4 == 0 && addr(lists) % 16 == 0 &&
                      addr(out) % 16 == 0;
  const auto grid = static_cast<unsigned>(Q);
  if (Q >= kManyQueries) {
    intersect_kernel<kThreadsMany><<<grid, kThreadsMany, 0, st>>>(
        l, c, kv, K, L, keep_base, aligned, o, oc);
  } else {
    intersect_kernel<kThreadsFew><<<grid, kThreadsFew, 0, st>>>(
        l, c, kv, K, L, keep_base, aligned, o, oc);
  }
  return static_cast<int>(cudaGetLastError());
}
