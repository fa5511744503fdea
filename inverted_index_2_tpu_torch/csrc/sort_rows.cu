// Kernel K4: ascending sort of each row of a (Q, M) uint32 matrix.
//
// Replaces inverted_index_2_tpu/ops/pallas_sort.py::sort_rows_pallas, the
// TPU's in-VMEM bitonic row sort, whose XLA twin (jnp.sort along rows) is
// the row sort and the compaction sort of every concat class
// (ops/concat_bool.py). M = 128 * 2^k; the wrapper pads other widths with
// 0xFFFFFFFF. Values compare as uint32, so 0xFFFFFFFF (the fill and a legal
// posting) sorts last.
//
// Design: a bitonic network over each row.
//   * Stages whose compare distance j lies inside a tile of
//     T = min(M, 16384) elements run on chip: one CTA loads its tile into
//     shared memory once, runs every such stage, and writes the tile back.
//     A row of up to 16384 values (every class chunk up to SB = 128) is one
//     CTA and one launch for the whole chunk.
//   * Inside a tile, distances j >= 16 are one shared-memory pass each
//     (a __syncthreads after it); the distances below 16 of a stage are one
//     pass in registers, each thread holding 16 consecutive values. Shared
//     memory is skewed (index i at i + i/32), so those 16-value loads and
//     stores hit 32 different banks across a warp.
//   * Longer rows (SB = 512 and up; shared memory holds at most 227 KiB a
//     block) first sort their tiles in alternating directions, then merge:
//     for each stage k > T, one global-memory compare-exchange pass per
//     distance j >= T (one thread per pair, all rows in one launch), then
//     the distances below T in shared memory again.
// The TPU kernel instead kept the whole row in VMEM and expressed the lane
// partner exchange as two rolls and a select; none of that carries over.
//
// Bound: device-memory bytes. Each row is read once and written once when
// it fits a tile; a longer row adds one read and one write per global pass
// and per merge of its tiles. The compares, log2(M) * (log2(M) + 1) / 4 per
// value, run on shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16384;        // elements one CTA sorts on chip
constexpr int kRun = 16;            // values a thread holds in registers
constexpr int kTileThreads = kTile / kRun;
constexpr int kPassThreads = 256;

// shared-memory slot of tile element i (one pad word per 32)
__device__ __forceinline__ int sk(int i) { return i + (i >> 5); }

__device__ __forceinline__ void cmp_swap(uint32_t& a, uint32_t& b, bool asc) {
  const uint32_t lo = min(a, b);
  const uint32_t hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Stages k = 2 .. kRun in registers: each run of kRun values ends sorted,
// ascending when bit kRun of its row index is 0.
__device__ void sort_runs(uint32_t* s, int tile, int64_t t0) {
  for (int base = threadIdx.x * kRun; base < tile; base += blockDim.x * kRun) {
    uint32_t v[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) v[e] = s[sk(base + e)];
    const bool up = ((t0 + base) & kRun) == 0;
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
__device__ void merge_runs(uint32_t* s, int tile, int64_t t0, int64_t k) {
  for (int base = threadIdx.x * kRun; base < tile; base += blockDim.x * kRun) {
    uint32_t v[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) v[e] = s[sk(base + e)];
    const bool asc = ((t0 + base) & k) == 0;
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

// Stages k = k_first .. k_last (powers of two, k_first either 2 or above
// the tile) of the bitonic network over one tile of `tile` elements of one
// row, held in shared memory. Stage k_first starts at distance j_first,
// every later stage at k / 2. Element i of the row is on an ascending run
// in stage k when (i & k) == 0. src rows have pitch src_pitch and src_cols
// real columns; columns at or past src_cols load as 0xFFFFFFFF. src may be
// dst: a CTA reads its whole tile before it writes it.
__global__ void __launch_bounds__(kTileThreads) sort_tile_kernel(
    const uint32_t* src, int64_t src_pitch, int64_t src_cols, uint32_t* dst,
    int64_t M, int tile, int64_t k_first, int64_t k_last, int j_first) {
  extern __shared__ uint32_t s[];
  const int64_t tiles_per_row = M / tile;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t t0 = (blockIdx.x - row * tiles_per_row) * tile;
  const uint32_t* srow = src + row * src_pitch;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int64_t c = t0 + e;
    s[sk(e)] = c < src_cols ? srow[c] : 0xFFFFFFFFu;
  }
  __syncthreads();
  int64_t k = k_first;
  if (k_first == 2) {
    sort_runs(s, tile, t0);
    __syncthreads();
    k = 2 * kRun;
  }
  const int half = tile / 2;
  for (; k <= k_last; k <<= 1) {
    int j = k == k_first ? j_first : static_cast<int>(k >> 1);
    for (; j >= kRun; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        uint32_t a = s[sk(i)];
        uint32_t b = s[sk(i + j)];
        cmp_swap(a, b, ((t0 + i) & k) == 0);
        s[sk(i)] = a;
        s[sk(i + j)] = b;
      }
      __syncthreads();
    }
    merge_runs(s, tile, t0, k);
    __syncthreads();
  }
  uint32_t* drow = dst + row * M + t0;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) drow[e] = s[sk(e)];
}

// One compare-exchange pass at distance j of stage k, over every row of x
// (Q, M): one thread per pair.
__global__ void __launch_bounds__(kPassThreads) bitonic_pass_kernel(
    uint32_t* __restrict__ x, int64_t M, int64_t n_pairs, int64_t k,
    int64_t j) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (g >= n_pairs) return;
  const int64_t half = M >> 1;
  const int64_t row = g / half;
  const int64_t p = g - row * half;
  const int64_t i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const bool asc = (i & k) == 0;
  uint32_t* r = x + row * M;
  const uint32_t a = r[i];
  const uint32_t b = r[i + j];
  if ((a > b) == asc) {
    r[i] = b;
    r[i + j] = a;
  }
}

}  // namespace

// in: (Q, in_cols) u32, contiguous; out: (Q, M) u32, M = 128 * 2^k >= in_cols.
// out receives each row of in, padded with 0xFFFFFFFF, sorted ascending.
// Returns the first CUDA error, or 0.
extern "C" int tpi_sort_rows(const void* in, int64_t in_cols, void* out,
                             int64_t Q, int64_t M, void* stream) {
  if (Q == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = M < kTile ? static_cast<int>(M) : kTile;
  const int threads = tile / kRun < 32 ? 32 : tile / kRun;
  const int smem = (tile + tile / 32) * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      sort_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = Q * (M / tile);
  uint32_t* x = static_cast<uint32_t*>(out);
  sort_tile_kernel<<<static_cast<unsigned>(tiles), threads, smem, st>>>(
      static_cast<const uint32_t*>(in), in_cols, in_cols, x, M, tile, 2, tile,
      1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_pairs = Q * (M / 2);
  const int64_t pass_grid = (n_pairs + kPassThreads - 1) / kPassThreads;
  for (int64_t k = 2 * static_cast<int64_t>(tile); k <= M; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile; j >>= 1) {
      bitonic_pass_kernel<<<static_cast<unsigned>(pass_grid), kPassThreads, 0,
                            st>>>(x, M, n_pairs, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sort_tile_kernel<<<static_cast<unsigned>(tiles), threads, smem, st>>>(
        x, M, M, x, M, tile, k, k, tile / 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
