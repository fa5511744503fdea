// Kernel K1: batched posting decode over the block arena.
//
// Replaces inverted_index_2_tpu/ops/pallas_decode.py::decode_postings_pallas
// (and its XLA twin ops/decode.py::gather_postings_arena). For Q term
// indexes it writes the first L postings of each term into vals (Q, L) and
// each term's raw count into raw (Q,).
//
// Bound: bytes. Per needed block (the first min(ceil(count / 128), L / 128)
// of a term) one arena row is read (stride * 4 bytes, 272 at a stride of 68
// words) and 512 bytes are written; per term 8 bytes of index and count
// tables are read and 4 written. The decode itself is a few shifts and a
// 5-step warp scan per lane.
//
// What stands in the way of that bound is the chain of dependent loads in
// front of a block (term index -> count and block start -> header and
// anchor -> packed words). A warp per (term, block) pair pays it per block,
// and at a mean list of half of L half of such warps find their block past
// the count and leave. Design:
//   * one warp per TERM. It reads the term's index, count and block start
//     once, writes the raw count, and walks only the blocks the count needs:
//     no warp exists for a block past the count.
//   * a term's blocks are one contiguous span of 16-byte-aligned arena rows.
//     The warp copies them row by row into its own ring of kStages rows in
//     shared memory with 16-byte cp.async copies (one per lane for a row of
//     up to 128 words) and keeps kStages - 1 rows in flight while it decodes
//     the row that has arrived, so the header, anchor and packed words of a
//     row arrive together and the next rows' latency hides behind the
//     current row's scan.
//   * a staged row is decoded without a bounds test per word: the ring's
//     rows are kMaxRowWords wide and the words past the stride are zeroed
//     once (decode.cuh, decode_block_warp_staged).
//   * with `found`, a row whose flag is 0 is neither read nor written and
//     reports a raw count of 0: a tier does not decode term 0's list for
//     every term it does not hold.
// Blocks at or past the count are not written: those lanes of vals stay
// undefined, as in the reference, and callers mask by count.
#include <cuda_runtime.h>

#include <cstdint>

#include "decode.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kStages = 4;

__global__ void __launch_bounds__(kWarps * 32) decode_postings_kernel(
    const uint32_t* __restrict__ blocks, int stride, int pitch,
    const int32_t* __restrict__ term_block_start,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ term_idx,
    const uint8_t* __restrict__ found, int Q, int K,
    uint32_t* __restrict__ vals, int32_t* __restrict__ raw) {
  extern __shared__ uint4 ring4[];  // kWarps x kStages rows of `pitch` words
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (q >= Q) return;  // whole warp
  if (found != nullptr && found[q] == 0) {  // whole warp
    if (lane == 0) raw[q] = 0;
    return;
  }
  uint32_t* ring =
      reinterpret_cast<uint32_t*>(ring4) + warp * kStages * pitch;
  // the words past the stride stay zero for the warp's whole life
  for (int s = 0; s < kStages; ++s) {
    for (int i = stride + lane; i < pitch; i += 32) ring[s * pitch + i] = 0u;
  }
  __syncwarp();
  const int32_t t = term_idx[q];
  const int32_t count = counts[t];
  if (lane == 0) raw[q] = count;
  const int need = (max(count, 0) + tpi::kBlock - 1) / tpi::kBlock;
  const int n_blk = min(need, K);
  const uint32_t* span =
      blocks + static_cast<int64_t>(term_block_start[t]) * stride;
  uint4* dst = reinterpret_cast<uint4*>(vals + q * K * tpi::kBlock) + lane;

  tpi::decode_rows_staged<kStages>(
      ring, pitch, stride, lane, n_blk,
      [&](int k) { return span + static_cast<int64_t>(k) * stride; },
      [&](int k, const uint32_t v[4]) {
        dst[k * (tpi::kBlock / 4)] = make_uint4(v[0], v[1], v[2], v[3]);
      });
}

}  // namespace

extern "C" const char* tpi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks (rows, stride) with stride % 4 == 0 and 16-byte-aligned rows; vals a
// fresh (Q, L) allocation (16-byte aligned rows), L % 128 == 0; raw (Q,);
// found (Q,) bytes or null. Returns the first CUDA error, or 0.
extern "C" int tpi_decode_postings(const void* blocks, int stride,
                                   const void* term_block_start,
                                   const void* counts, const void* term_idx,
                                   const void* found, int Q, int L, void* vals,
                                   void* raw, void* stream) {
  if (Q == 0) return 0;
  if (stride < 4 || stride % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pitch = stride > tpi::kMaxRowWords ? stride : tpi::kMaxRowWords;
  const int smem = kWarps * kStages * pitch * static_cast<int>(sizeof(uint32_t));
  static int allowed_smem = 0;  // raised once per stride, not per launch
  if (smem > allowed_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_postings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_smem = smem;
  }
  const int grid = (Q + kWarps - 1) / kWarps;
  decode_postings_kernel<<<grid, kWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), stride, pitch,
      static_cast<const int32_t*>(term_block_start),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(term_idx),
      static_cast<const uint8_t*>(found), Q, L / tpi::kBlock,
      static_cast<uint32_t*>(vals), static_cast<int32_t*>(raw));
  return static_cast<int>(cudaGetLastError());
}
