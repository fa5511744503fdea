// Kernel K4: ascending sort of each row of a (Q, M) uint32 matrix, in three
// entries designed for the card around what the callers' rows already are.
//
// Replaces inverted_index_2_tpu/ops/pallas_sort.py::sort_rows_pallas, the
// TPU's in-VMEM bitonic row sort, whose XLA twin (jnp.sort along rows) is
// the row sort and the compaction sort of every concat class
// (ops/concat_bool.py) and of the set operations (ops/setops.py). The TPU
// sorts because it has no cheap scatter and no cheap data-dependent merge;
// this card has both, and no caller hands K4 an unsorted row:
//   * a compaction's kept lanes already ascend (the rest is fill);
//   * a pair union's row is two ascending runs;
//   * a concat-class row is a concatenation of ascending 128-lane blocks.
// Values compare as uint32 everywhere, so 0xFFFFFFFF (the fill and a legal
// posting) sorts last. ops/cuda_sort.py plans which entries a row takes.
//
// Entry 1, tpi_compact_rows: the kept lanes of a row, in order, at the front
// of the output row, 0xFFFFFFFF to its end. One CTA per row walks the row in
// tiles; a warp reads 32 consecutive lanes at a time (values and keep
// bytes), a ballot gives each kept lane its place in the warp, a block scan
// of the warps' totals its place in the tile, and the CTA's loop carries
// the running offset of a row longer than one tile. Any M and any row
// pitch. Bound: bytes, 5 read (value and keep byte) and 4 written per lane.
//
// Entry 2, tpi_sort_tiles: a bitonic network over tiles of up to 16384
// values in shared memory, one CTA per tile, every tile ending ascending.
// A row of up to 16384 values is one tile, read once and written once.
// The compare-exchange steps are bound by shared-memory traffic, so a stage's
// distances go in groups of up to four, each group one pass in registers: a
// thread holds the 16 values that four distances connect (for the distances
// below 16, 16 consecutive values) and pays one load and one store per value
// for four steps. Shared memory is skewed (index i at i + i/32), so a warp's
// loads and stores hit 32 different banks. A full sort of 8192 values is 25
// passes over shared memory, not 55. With run = r
// (a power of two >= 16) the caller states that every r consecutive lanes
// already ascend: odd runs are mirrored on the load, which makes them
// descending as stage 2r expects, and the network starts at stage 2r. A
// row of 128-lane blocks at M = 8192 takes 63 compare-exchange steps a
// value instead of 91.
//
// Entry 3, tpi_merge_runs: one merge level over global memory by merge
// path. The row is a sequence of ascending runs of w lanes (any w, the last
// run may be short); each pair of runs becomes one ascending run of 2w. A
// CTA owns 4096 output lanes of one pair: two threads binary-search the
// pair's two diagonals for the CTA's split, the CTA loads its at most 4096
// input values into shared memory, every thread finds its own split there
// and merges 16 values serially, and the tile is written once. One read and
// one write of the matrix per level, whatever w. This is
//   * the pair union: a row of two runs is ONE level, any run length (2 x
//     13568 lanes just as 2 x 2048), no padding, instead of a full sort;
//   * the general sort past one tile: tiles of 16384 are sorted by entry 2
//     and merged in log2(M / 16384) levels. At M = 262144 that is 1 + 4
//     passes, each reading and writing the matrix once (10 x Q x M x 4
//     bytes in all), where a bitonic network over global memory takes 15
//     launches, 10 of them compare-exchange passes over the matrix at one
//     distance each and 5 over the tiles (30 x Q x M x 4 bytes).
//
// Bound of the sorts: device-memory bytes, one read and one write of the
// matrix; each merge level past the first adds one of each. The compares run
// on shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kFill = 0xFFFFFFFFu;
constexpr int64_t kMaxGrid = 0x7FFFFFFF;

// shared-memory slot of element i (one pad word per 32)
__device__ __forceinline__ int sk(int i) { return i + (i >> 5); }

// ---------------------------------------------------------------------------
// entry 2: bitonic network over tiles in shared memory

constexpr int kTile = 16384;        // most elements one CTA sorts on chip
constexpr int kRun = 16;            // values a thread holds in registers
constexpr int kTileThreads = kTile / kRun;

__device__ __forceinline__ void cmp_swap(uint32_t& a, uint32_t& b, bool asc) {
  const uint32_t lo = min(a, b);
  const uint32_t hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Stages k = 2 .. kRun in registers: each run of kRun values ends sorted,
// ascending when bit kRun of its index in the tile is 0.
__device__ void sort_regs(uint32_t* s, int tile) {
  for (int base = threadIdx.x * kRun; base < tile; base += blockDim.x * kRun) {
    uint32_t v[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) v[e] = s[sk(base + e)];
    const bool up = (base & kRun) == 0;
#pragma unroll
    for (int k = 2; k <= kRun; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j >= 1; j >>= 1) {
#pragma unroll
        for (int e = 0; e < kRun; ++e) {
          if ((e & j) == 0) {
            cmp_swap(v[e], v[e + j], k == kRun ? up : (e & k) == 0);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kRun; ++e) s[sk(base + e)] = v[e];
  }
}

// Distances kRun/2 .. 1 of stage k >= 2 * kRun in registers: a run of
// kRun values lies on one ascending or descending run of stage k.
__device__ void merge_regs(uint32_t* s, int tile, int k) {
  for (int base = threadIdx.x * kRun; base < tile; base += blockDim.x * kRun) {
    uint32_t v[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) v[e] = s[sk(base + e)];
    const bool asc = (base & k) == 0;
#pragma unroll
    for (int j = kRun / 2; j >= 1; j >>= 1) {
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if ((e & j) == 0) cmp_swap(v[e], v[e + j], asc);
      }
    }
#pragma unroll
    for (int e = 0; e < kRun; ++e) s[sk(base + e)] = v[e];
  }
}

// Distances j_hi, j_hi / 2, .. j_hi >> (LEV - 1), all >= kRun, of stage k
// in registers: a thread holds the 2^LEV values whose indexes differ only in
// the LEV bits those distances flip, so LEV compare-exchange steps cost one
// shared-memory load and store per value, not LEV. Neighbouring threads hold
// neighbouring lanes, so each load and store is conflict-free (two-way at
// the lowest distance, 16). The values of a thread lie on one run of stage
// k: k >= 2 * j_hi.
template <int LEV>
__device__ void pass_regs(uint32_t* s, int tile, int k, int j_hi) {
  constexpr int N = 1 << LEV;
  const int j_lo = j_hi >> (LEV - 1);
  for (int g = threadIdx.x; g < tile / N; g += blockDim.x) {
    const int low = g & (j_lo - 1);
    const int base = ((g - low) << LEV) | low;
    uint32_t v[N];
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = s[sk(base + e * j_lo)];
    const bool asc = (base & k) == 0;
#pragma unroll
    for (int d = N / 2; d >= 1; d >>= 1) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if ((e & d) == 0) cmp_swap(v[e], v[e + d], asc);
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) s[sk(base + e * j_lo)] = v[e];
  }
}

// One CTA sorts one tile of `tile` (a power of two, 128 .. kTile) lanes of
// one row ascending. Element e of the tile is on an ascending run in stage k
// when (e & k) == 0; the last stage, k = tile, is ascending for every tile.
// Columns at or past `cols` load as 0xFFFFFFFF and are not written: they
// sort behind the tile's own values. run = 1: the whole network. run >= kRun
// (a power of two below tile): every run of `run` lanes of the source
// ascends; odd runs are loaded mirrored and the network starts at stage
// 2 * run. src must not be dst.
__global__ void __launch_bounds__(kTileThreads) sort_tiles_kernel(
    const uint32_t* __restrict__ src, int64_t src_pitch, int64_t cols,
    uint32_t* __restrict__ dst, int64_t dst_pitch, int tile,
    int64_t tiles_per_row, int run) {
  extern __shared__ uint32_t s[];
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t t0 = (blockIdx.x - row * tiles_per_row) * tile;
  const uint32_t* srow = src + row * src_pitch;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int from = (run > 1 && (e & run)) ? (e ^ (run - 1)) : e;
    const int64_t c = t0 + from;
    s[sk(e)] = c < cols ? srow[c] : kFill;
  }
  __syncthreads();
  int k = 2 * run;
  if (run == 1) {
    sort_regs(s, tile);
    __syncthreads();
    k = 2 * kRun;
  }
  for (; k <= tile; k <<= 1) {
    int j = k >> 1;
    while (j >= kRun) {  // uniform across the CTA
      const int left = 28 - __clz(j);  // distances j, j / 2, .. kRun
      if (left >= 4) {
        pass_regs<4>(s, tile, k, j);
        j >>= 4;
      } else if (left == 3) {
        pass_regs<3>(s, tile, k, j);
        j >>= 3;
      } else if (left == 2) {
        pass_regs<2>(s, tile, k, j);
        j >>= 2;
      } else {
        pass_regs<1>(s, tile, k, j);
        j >>= 1;
      }
      __syncthreads();
    }
    merge_regs(s, tile, k);
    __syncthreads();
  }
  uint32_t* drow = dst + row * dst_pitch;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t c = t0 + e;
    if (c < cols) drow[c] = s[sk(e)];
  }
}

// ---------------------------------------------------------------------------
// entry 3: one merge level by merge path

constexpr int kMergeThreads = 256;
constexpr int kMergeRun = 16;                            // values a thread merges
constexpr int kMergeTile = kMergeThreads * kMergeRun;    // output lanes per CTA

// How many of the first `diag` values of the merge of a[0, na) and b[0, nb)
// come from a (ties take a first). 0 <= diag <= na + nb.
__device__ __forceinline__ int merge_split(const uint32_t* a, int na,
                                           const uint32_t* b, int nb,
                                           int diag) {
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// src rows are ascending runs of w lanes (the last may be short); dst
// receives every pair of runs merged. One CTA per kMergeTile output lanes of
// one pair. src must not be dst.
__global__ void __launch_bounds__(kMergeThreads) merge_runs_kernel(
    const uint32_t* __restrict__ src, int64_t src_pitch,
    uint32_t* __restrict__ dst, int64_t dst_pitch, int64_t m, int64_t w,
    int64_t pairs_per_row, int64_t tiles_per_pair) {
  __shared__ uint32_t s_in[kMergeTile];
  __shared__ uint32_t s_out[kMergeTile + kMergeTile / 32];
  __shared__ int split[2];
  int64_t b = blockIdx.x;
  const int64_t tile = b % tiles_per_pair;
  b /= tiles_per_pair;
  const int64_t pair = b % pairs_per_row;
  const int64_t row = b / pairs_per_row;
  const int64_t p0 = pair * 2 * w;
  const int64_t left = m - p0;  // lanes of this pair and the later ones
  const int len_a = static_cast<int>(left < w ? left : w);
  const int len_b =
      static_cast<int>(left <= w ? 0 : (left - w < w ? left - w : w));
  const int total = len_a + len_b;
  const int64_t d0_64 = tile * kMergeTile;
  if (d0_64 >= total) return;  // the whole CTA: a short last pair
  const int d0 = static_cast<int>(d0_64);
  const int d1 = min(d0 + kMergeTile, total);
  const uint32_t* A = src + row * src_pitch + p0;
  const uint32_t* B = A + w;  // read only when len_b > 0
  if (threadIdx.x == 0) split[0] = merge_split(A, len_a, B, len_b, d0);
  if (threadIdx.x == 32) split[1] = merge_split(A, len_a, B, len_b, d1);
  __syncthreads();
  const int a0 = split[0];
  const int b0 = d0 - a0;
  const int na = split[1] - a0;
  const int n = d1 - d0;
  const int nb = n - na;
  for (int i = threadIdx.x; i < na; i += kMergeThreads) s_in[i] = A[a0 + i];
  for (int i = threadIdx.x; i < nb; i += kMergeThreads) s_in[na + i] = B[b0 + i];
  __syncthreads();

  const uint32_t* sa = s_in;
  const uint32_t* sb = s_in + na;
  const int diag = min(static_cast<int>(threadIdx.x) * kMergeRun, n);
  int ai = merge_split(sa, na, sb, nb, diag);
  int bi = diag - ai;
  uint32_t av = ai < na ? sa[ai] : 0u;
  uint32_t bv = bi < nb ? sb[bi] : 0u;
#pragma unroll
  for (int e = 0; e < kMergeRun; ++e) {
    // past the tile's end (both exhausted) the value is never written out
    const bool take_a = bi >= nb || (ai < na && av <= bv);
    s_out[sk(threadIdx.x * kMergeRun + e)] = take_a ? av : bv;
    if (take_a) {
      ++ai;
      av = ai < na ? sa[ai] : 0u;
    } else {
      ++bi;
      bv = bi < nb ? sb[bi] : 0u;
    }
  }
  __syncthreads();
  uint32_t* drow = dst + row * dst_pitch + p0 + d0;
  for (int i = threadIdx.x; i < n; i += kMergeThreads) drow[i] = s_out[sk(i)];
}

// ---------------------------------------------------------------------------
// entry 1: compaction of kept lanes

constexpr int kCompactRun = 8;          // 32-lane groups a warp holds
constexpr int kCompactMaxWarps = 16;

__global__ void __launch_bounds__(kCompactMaxWarps * 32) compact_rows_kernel(
    const uint32_t* __restrict__ vals, int64_t vals_pitch,
    const uint8_t* __restrict__ keep, int64_t keep_pitch,
    uint32_t* __restrict__ out, int64_t m) {
  __shared__ int warp_total[kCompactMaxWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t row = blockIdx.x;
  const uint32_t* vrow = vals + row * vals_pitch;
  const uint8_t* krow = keep + row * keep_pitch;
  uint32_t* orow = out + row * m;
  const int64_t tile = static_cast<int64_t>(n_warps) * 32 * kCompactRun;
  const uint32_t below = (1u << lane) - 1u;
  int64_t written = 0;

  for (int64_t t0 = 0; t0 < m; t0 += tile) {  // uniform across the CTA
    const int64_t base = t0 + static_cast<int64_t>(warp) * 32 * kCompactRun + lane;
    uint32_t v[kCompactRun];
    int pre[kCompactRun];  // kept lanes of this warp before mine, or -1
    int wsum = 0;
#pragma unroll
    for (int e = 0; e < kCompactRun; ++e) {
      const int64_t c = base + e * 32;
      const bool in = c < m;
      v[e] = in ? vrow[c] : 0u;
      const bool k = in && krow[c] != 0;
      const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, k);
      pre[e] = k ? wsum + __popc(ballot & below) : -1;
      wsum += __popc(ballot);
    }
    if (lane == 0) warp_total[warp] = wsum;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int x = warp_total[w];
      before += w < warp ? x : 0;
      total += x;
    }
    uint32_t* o = orow + written + before;
#pragma unroll
    for (int e = 0; e < kCompactRun; ++e) {
      if (pre[e] >= 0) o[pre[e]] = v[e];
    }
    written += total;
    __syncthreads();  // warp_total is reused by the next tile
  }
  for (int64_t i = written + threadIdx.x; i < m; i += blockDim.x) orow[i] = kFill;
}

}  // namespace

// vals (Q, m) u32 with row pitch vals_pitch (elements), keep (Q, m) bytes
// (non-zero = kept) with row pitch keep_pitch, out (Q, m) u32 contiguous and
// distinct from vals. out receives each row's kept lanes in order, then
// 0xFFFFFFFF. Returns the first CUDA error, or 0.
extern "C" int tpi_compact_rows(const void* vals, int64_t vals_pitch,
                                const void* keep, int64_t keep_pitch,
                                void* out, int64_t Q, int64_t m,
                                void* stream) {
  if (Q == 0 || m == 0) return 0;
  if (Q > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_warp = 32 * kCompactRun;
  int64_t warps = (m + per_warp - 1) / per_warp;
  if (warps > kCompactMaxWarps) warps = kCompactMaxWarps;
  compact_rows_kernel<<<static_cast<unsigned>(Q),
                        static_cast<unsigned>(warps * 32), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vals), vals_pitch,
      static_cast<const uint8_t*>(keep), keep_pitch,
      static_cast<uint32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// src (Q, m) u32 with row pitch src_pitch, dst (Q, m) with row pitch
// dst_pitch, distinct from src. Each row is cut into tiles of `tile` lanes
// (a power of two in [128, 16384]); dst receives every tile sorted
// ascending. run: 1, or a power of two in [16, tile) with every `run`
// consecutive lanes of src ascending. Returns the first CUDA error, or 0.
extern "C" int tpi_sort_tiles(const void* src, int64_t src_pitch, void* dst,
                              int64_t dst_pitch, int64_t Q, int64_t m,
                              int tile, int run, void* stream) {
  if (Q == 0 || m == 0) return 0;
  const bool pow2 = tile >= 128 && tile <= kTile && (tile & (tile - 1)) == 0;
  const bool run_ok =
      run == 1 || (run >= kRun && run < tile && (run & (run - 1)) == 0);
  const int64_t tiles_per_row = (m + tile - 1) / tile;
  if (!pow2 || !run_ok || tiles_per_row > kMaxGrid / Q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = tile / kRun < 32 ? 32 : tile / kRun;
  const int smem = (tile + tile / 32) * static_cast<int>(sizeof(uint32_t));
  static int allowed_smem = 0;  // raised once per tile size, not per launch
  if (smem > allowed_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_smem = smem;
  }
  sort_tiles_kernel<<<static_cast<unsigned>(Q * tiles_per_row), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), src_pitch, m,
      static_cast<uint32_t*>(dst), dst_pitch, tile, tiles_per_row, run);
  return static_cast<int>(cudaGetLastError());
}

// src (Q, m) u32 rows of ascending runs of w lanes (the last may be short),
// dst (Q, m) distinct from src: every pair of runs merged into one ascending
// run of 2w. m < 2^30. Returns the first CUDA error, or 0.
extern "C" int tpi_merge_runs(const void* src, int64_t src_pitch, void* dst,
                              int64_t dst_pitch, int64_t Q, int64_t m,
                              int64_t w, void* stream) {
  if (Q == 0 || m == 0) return 0;
  if (w < 1 || m >= (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pair = 2 * w < m ? 2 * w : m;  // lanes of a full pair
  const int64_t pairs_per_row = (m + 2 * w - 1) / (2 * w);
  const int64_t tiles_per_pair = (pair + kMergeTile - 1) / kMergeTile;
  if (pairs_per_row * tiles_per_pair > kMaxGrid / Q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  merge_runs_kernel<<<static_cast<unsigned>(Q * pairs_per_row * tiles_per_pair),
                      kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), src_pitch,
      static_cast<uint32_t*>(dst), dst_pitch, m, w, pairs_per_row,
      tiles_per_pair);
  return static_cast<int>(cudaGetLastError());
}
