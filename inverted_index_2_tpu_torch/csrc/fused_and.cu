// Kernel K2: fused decode + AND over arena-resident posting lists.
//
// Replaces inverted_index_2_tpu/ops/pallas_fused.py::fused_and_pallas. For
// each query q the caller has put its smallest list in slot 0 (the base).
// Output: out (Q, L) holds base[p] where position p is a member of every
// probe list (slots 1 .. k_valid-1) and 0xFFFFFFFF elsewhere; out_count
// (Q,) the number of kept positions. Positions at or past the base count
// are never kept, and a probe with count 0 empties the result.
//
// Design: one CTA (8 warps) per query.
//   * The base window (first min(count, L) values) is decoded into shared
//     memory, 4*L bytes (64 KiB at L = 16384, the port's level cap), next to
//     two L-bit masks: `keep` and the current probe's `hit`.
//   * Each probe list is walked to its full length, one block per warp at a
//     time (decode_block_warp). A block whose anchor passes the base's max
//     ends that warp's walk (later blocks start higher still); a block whose
//     successor's anchor is at or below the base's min is skipped. Both only
//     save work: every skipped value lies outside [base_min, base_max].
//   * Membership: each probe value in [base_min, base_max] is binary-searched
//     in the sorted base (u32 order) and its position's hit bit is set with
//     a shared-memory atomicOr. After the probe, keep &= hit.
// The TPU kernel instead compared every probe chunk against every base chunk
// on the vector unit (a broadcast compare) and pruned with scalar guards.
//
// Bound: probe bytes (every probe row that survives the range tests is read
// once from device memory) and the binary-search compares, about
// log2(min(count0, L)) shared-memory reads per probe value in range.
#include <cuda_runtime.h>

#include <cstdint>

#include "decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int lower_bound_u32(const uint32_t* a, int n,
                                               uint32_t x) {
  int lo = 0, hi = n;
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

__global__ void __launch_bounds__(kThreads) fused_and_kernel(
    const uint32_t* __restrict__ blocks, int stride,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ k_valid, int K, int L,
    uint32_t* __restrict__ out, int32_t* __restrict__ out_count) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int kept_total;
  const int nwords = L / 32;
  uint32_t* base = smem;          // L decoded base values
  uint32_t* keep = base + L;      // L bits
  uint32_t* hit = keep + nwords;  // L bits

  const int64_t q = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* qrows = rows + q * K;
  const int32_t* qcounts = counts + q * K;
  const int nbv = min(max(qcounts[0], 0), L);  // base values in the window
  const int nb0 = (nbv + tpi::kBlock - 1) / tpi::kBlock;

  for (int b = warp; b < nb0; b += kWarps) {
    uint32_t v[4];
    tpi::decode_block_warp(
        blocks + (static_cast<int64_t>(qrows[0]) + b) * stride, stride, lane, v);
    reinterpret_cast<uint4*>(base + b * tpi::kBlock)[lane] =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int w = threadIdx.x; w < nwords; w += kThreads) {
    const int lo = w * 32;
    keep[w] = nbv >= lo + 32 ? 0xFFFFFFFFu
                             : (nbv > lo ? (1u << (nbv - lo)) - 1u : 0u);
  }
  if (threadIdx.x == 0) kept_total = 0;
  __syncthreads();

  const int kv = k_valid[q];
  if (nbv > 0) {
    const uint32_t bmin = base[0];
    const uint32_t bmax = base[nbv - 1];
    for (int j = 1; j < kv; ++j) {
      for (int w = threadIdx.x; w < nwords; w += kThreads) hit[w] = 0u;
      __syncthreads();
      const int nj = max(qcounts[j], 0);
      const int nbj = (nj + tpi::kBlock - 1) / tpi::kBlock;
      const uint32_t* first = blocks + static_cast<int64_t>(qrows[j]) * stride;
      for (int b = warp; b < nbj; b += kWarps) {
        const uint32_t* row = first + static_cast<int64_t>(b) * stride;
        if (__ldg(row + 1) > bmax) break;  // anchors ascend along the list
        if (b + 1 < nbj && __ldg(row + stride + 1) <= bmin) continue;
        uint32_t v[4];
        tpi::decode_block_warp(row, stride, lane, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = b * tpi::kBlock + 4 * lane + i;
          const uint32_t x = v[i];
          if (idx < nj && x >= bmin && x <= bmax) {
            const int p = lower_bound_u32(base, nbv, x);
            if (p < nbv && base[p] == x) atomicOr(&hit[p >> 5], 1u << (p & 31));
          }
        }
      }
      __syncthreads();
      for (int w = threadIdx.x; w < nwords; w += kThreads) keep[w] &= hit[w];
      __syncthreads();
    }
  }

  uint32_t* orow = out + q * L;
  for (int p = threadIdx.x; p < L; p += kThreads) {
    const bool kp = (keep[p >> 5] >> (p & 31)) & 1u;
    orow[p] = kp ? base[p] : 0xFFFFFFFFu;
  }
  for (int w = threadIdx.x; w < nwords; w += kThreads) {
    const int c = __popc(keep[w]);
    if (c) atomicAdd(&kept_total, c);
  }
  __syncthreads();
  if (threadIdx.x == 0) out_count[q] = kept_total;
}

}  // namespace

// rows/counts: (Q, K) int32, k_valid: (Q,) int32, out: (Q, L) u32,
// out_count: (Q,) int32; L % 128 == 0 and 4.25 * L bytes of shared memory
// must fit the card. Returns the first CUDA error, or 0.
extern "C" int tpi_fused_and(const void* blocks, int stride, const void* rows,
                             const void* counts, const void* k_valid, int Q,
                             int K, int L, void* out, void* out_count,
                             void* stream) {
  if (Q == 0) return 0;
  const int smem = (L + 2 * (L / 32)) * static_cast<int>(sizeof(uint32_t));
  const cudaError_t err = cudaFuncSetAttribute(
      fused_and_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_and_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), stride,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(k_valid), K, L, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(out_count));
  return static_cast<int>(cudaGetLastError());
}
