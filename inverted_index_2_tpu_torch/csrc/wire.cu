// The device half of the full-result wire codec (models/steps.py
// _wire_meta_step and _wire_pack_step) on the card.
//
// Replaces no TPU kernel: the JAX package runs both steps as plain XLA, and
// the port ran them as chains of int64 torch ops over every lane of a result
// matrix (n, S): some 12 launches for the meta and 8 to 12 for the pack, with
// some 240 bytes of temporaries a lane. In a full result only the first
// oc[r] lanes of row r count and the rest is fill, so the kernels read the
// kept lanes alone.
//
// Entry 1, tpi_wire_meta: the masked max of (o[r, i+1] - o[r, i]) mod 2^32
// over i < oc[r] - 1, the width the host chooses the wire by, into one
// int64 word (0 where no row has two values). The grid is (row, tile of
// kTile deltas) over the whole width, so 8 rows of 2^22 lanes fill the card
// as 256 short rows do; a tile at or past the row's kept deltas returns at
// once. A CTA reduces its tile and makes one atomicMax on the word, which
// the entry zeroes on the stream first. The delta is a u32, so a delta of
// 2^31 or more stays positive in the int64 word and still picks raw u32.
// Bound: bytes, the kept lanes read once (a tile's last lane twice).
//
// Entry 2, tpi_wire_pack: first[r] = o[r, 0] and the delta plane
// dd[r, j] = (o[r, j+1] - o[r, j]) mod 2^bits for j < M, bits 8 or 16,
// written contiguous (n, M) for the copy to the host. M = maxc - 1, the
// widest row's deltas; lanes past a row's own count may wrap, and the host
// trims them. Bound: bytes, n * (M + 1) lanes read and 1 or 2 bytes
// written a delta.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;  // lanes a thread holds
constexpr int kTile = kThreads * kRun;
constexpr int64_t kMaxGrid = 0x7FFFFFFF;

__device__ __forceinline__ int64_t count_of(const void* oc, int oc64,
                                            int64_t r) {
  return oc64 ? static_cast<const int64_t*>(oc)[r]
              : static_cast<int64_t>(static_cast<const int32_t*>(oc)[r]);
}

// One CTA per (row r, tile t) of the S - 1 deltas.
__global__ void __launch_bounds__(kThreads) wire_meta_kernel(
    const uint32_t* __restrict__ o, int64_t pitch, int64_t S,
    const void* __restrict__ oc, int oc64, int64_t tiles,
    unsigned long long* __restrict__ md) {
  __shared__ uint32_t warp_max[kThreads / 32];
  const int64_t r = blockIdx.x / tiles;
  const int64_t t = blockIdx.x - r * tiles;
  const int64_t kept = min(count_of(oc, oc64, r), S) - 1;  // deltas kept
  const int64_t d0 = t * kTile;
  if (d0 >= kept) return;  // the whole CTA
  const uint32_t* row = o + r * pitch;
  uint32_t m = 0u;
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const int64_t i = d0 + e * kThreads + threadIdx.x;
    if (i < kept) m = max(m, row[i + 1] - row[i]);
  }
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    if (m != 0u) atomicMax(md, static_cast<unsigned long long>(m));
  }
}

// One CTA per (row r, tile t) of the M deltas a row ships.
template <typename D>
__global__ void __launch_bounds__(kThreads) wire_pack_kernel(
    const uint32_t* __restrict__ o, int64_t pitch, int64_t M, int64_t tiles,
    uint32_t* __restrict__ first, D* __restrict__ dd) {
  const int64_t r = blockIdx.x / tiles;
  const int64_t t = blockIdx.x - r * tiles;
  const uint32_t* row = o + r * pitch;
  if (t == 0 && threadIdx.x == 0) first[r] = row[0];
  D* drow = dd + r * M;
  const int64_t j0 = t * kTile;
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const int64_t j = j0 + e * kThreads + threadIdx.x;
    if (j < M) drow[j] = static_cast<D>(row[j + 1] - row[j]);
  }
}

}  // namespace

// o (n, S) u32 rows at a pitch of `pitch` words, oc (n,) int32 (oc64 0) or
// int64 (oc64 1) row counts; md one int64 word, zeroed here, then the
// masked max delta. Returns the first CUDA error, or 0.
extern "C" int tpi_wire_meta(const void* o, int64_t pitch, int64_t n,
                             int64_t S, const void* oc, int oc64, void* md,
                             void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(md, 0, sizeof(int64_t), st);
  if (err != cudaSuccess || n == 0 || S < 2) return static_cast<int>(err);
  const int64_t tiles = (S - 1 + kTile - 1) / kTile;
  if (tiles > kMaxGrid / n) return static_cast<int>(cudaErrorInvalidValue);
  wire_meta_kernel<<<static_cast<unsigned>(n * tiles), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(o), pitch, S, oc, oc64, tiles,
      static_cast<unsigned long long*>(md));
  return static_cast<int>(cudaGetLastError());
}

// o (n, >= M + 1) u32 rows at a pitch of `pitch` words; first (n,) u32 and
// dd (n, M) contiguous, u8 (bits 8) or u16 (bits 16). Returns the first
// CUDA error, or 0.
extern "C" int tpi_wire_pack(const void* o, int64_t pitch, int64_t n,
                             int64_t M, int bits, void* first, void* dd,
                             void* stream) {
  if (n == 0) return 0;
  if (M < 0 || (bits != 8 && bits != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = M > 0 ? (M + kTile - 1) / kTile : 1;
  if (tiles > kMaxGrid / n) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint32_t*>(o);
  auto* f = static_cast<uint32_t*>(first);
  const unsigned grid = static_cast<unsigned>(n * tiles);
  if (bits == 8) {
    wire_pack_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        src, pitch, M, tiles, f, static_cast<uint8_t*>(dd));
  } else {
    wire_pack_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        src, pitch, M, tiles, f, static_cast<uint16_t*>(dd));
  }
  return static_cast<int>(cudaGetLastError());
}
