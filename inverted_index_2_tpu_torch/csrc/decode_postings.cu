// Kernel K1: batched posting decode over the block arena.
//
// Replaces inverted_index_2_tpu/ops/pallas_decode.py::decode_postings_pallas
// (and its XLA twin ops/decode.py::gather_postings_arena). For Q term
// indexes it writes the first L postings of each term into vals (Q, L).
//
// Design: one warp per (query, block) pair; a term's blocks are consecutive
// arena rows, so warp (q, k) decodes row term_block_start[t] + k and stores
// its 128 values as one 512-byte coalesced write (16 bytes a lane). Blocks
// at or past ceil(count / 128) are neither read nor written: those lanes of
// vals stay undefined, as in the reference, and callers mask by count.
//
// Bound: arena bytes. Each block row is read once (stride * 4 bytes, about
// 272 bytes at the config-3 stride of 68 words) and 512 bytes are written;
// the decode is a few shifts and a 5-step warp scan per lane.
#include <cuda_runtime.h>

#include <cstdint>

#include "decode.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32) decode_postings_kernel(
    const uint32_t* __restrict__ blocks, int stride,
    const int32_t* __restrict__ term_block_start,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ term_idx,
    int64_t n_items, int K, uint32_t* __restrict__ vals) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;  // whole warp
  const int64_t q = item / K;
  const int k = static_cast<int>(item - q * K);
  const int32_t t = term_idx[q];
  if (static_cast<int64_t>(k) * tpi::kBlock >= counts[t]) return;  // whole warp
  const uint32_t* row =
      blocks + (static_cast<int64_t>(term_block_start[t]) + k) * stride;
  uint32_t v[4];
  tpi::decode_block_warp(row, stride, lane, v);
  uint4* dst = reinterpret_cast<uint4*>(vals + item * tpi::kBlock) + lane;
  *dst = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" const char* tpi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vals must be a fresh (Q, L) allocation (16-byte aligned rows); L % 128 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int tpi_decode_postings(const void* blocks, int stride,
                                   const void* term_block_start,
                                   const void* counts, const void* term_idx,
                                   int Q, int L, void* vals, void* stream) {
  const int K = L / tpi::kBlock;
  const int64_t n_items = static_cast<int64_t>(Q) * K;
  if (n_items == 0) return 0;
  const int64_t grid = (n_items + kWarps - 1) / kWarps;
  decode_postings_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), stride,
      static_cast<const int32_t*>(term_block_start),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(term_idx), n_items, K,
      static_cast<uint32_t*>(vals));
  return static_cast<int>(cudaGetLastError());
}
