// Kernel K2: fused decode + AND over arena-resident posting lists.
//
// Replaces inverted_index_2_tpu/ops/pallas_fused.py::fused_and_pallas. For
// each query q slot 0 holds the base list (the caller puts the smallest
// there) and slots 1 .. k_valid-1 the probes. A position p of the base
// window (the first min(count, L) values) is kept when base[p] is a member
// of every probe list, each walked to its full length; a probe with count 0
// empties the result. Two outputs:
//   masked   out (Q, L): base[p] where p is kept, 0xFFFFFFFF elsewhere;
//   compact  out (Q, P): the first P kept values ascending, then 0xFFFFFFFF
//            (P = L gives the whole result; a small P is the page that the
//            staged stream ships).
// out_count (Q,) is the number of kept positions in both. The TPU kernel
// compared every probe chunk against every base chunk on the vector unit,
// pruned with scalar guards, and could only mask: a TPU has no cheap
// scatter, so its callers sort or take P masked minima afterwards.
//
// Bound: device-memory bytes, few of them: the base's rows, one anchor per
// probe block in the base's range, the rows of the probe blocks whose own
// range holds a base value, and the output. What costs time on this card is
// the chain of dependent reads in front of each block (row index -> anchor
// -> header -> packed words -> search), paid probe after probe with barriers
// between. What this design does, one CTA per query:
//   * Rows come in through per-warp rings of 16-byte cp.async copies and
//     decode from shared memory (decode.cuh decode_rows_staged), the base's
//     and the probes' alike.
//   * The base window is decoded once into shared memory (4 L bytes).
//   * All (probe, block) pairs form one flat list of work, a thread each:
//     the thread reads the block's anchor and the next one and searches the
//     base for them. Values of the block lie in [anchor, next anchor), so
//     only base positions [plo, phi) can match; a block with plo = phi is
//     never fetched. The rest go to a work list, and the warps decode them
//     with no barrier between probes.
//   * When the probes have no more than kThreads blocks in all (the usual
//     query), the anchors are read while the base's rows are still on their
//     way, so a query is three dependent trips to device memory: its slots,
//     then base rows and anchors together, then the probe rows it needs.
//     Longer probes first have their blocks cut, one warp per probe, to the
//     span whose anchors lie in [base_min, base_max], with 32 reads a round
//     (search.cuh warp_bounds).
//   * A decoded value is searched in base[plo, phi) only, and a match adds
//     one to its position's hit counter (a byte; shared-memory atomic on its
//     word). Values are unique within a list, so a position is kept when
//     its counter reaches k_valid - 1.
//   * The kept values are compacted by a block scan in base order, so they
//     ascend; a genuine 0xFFFFFFFF member is kept by its counter, not by its
//     value, and lands where the fill would.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "decode.cuh"
#include "search.cuh"

namespace {

// Threads of a CTA. At the serving width a query's work is small (a base of
// a few hundred values, some tens of probe blocks, a handful of rows to
// fetch), and with many queries small CTAs hide more of each other's waits:
// 128 threads measured faster than 256 and than 64. A ladder re-serve (a few
// hundred queries, bases of thousands of values) takes 256.
constexpr int kThreadsMany = 128;
constexpr int kThreadsFew = 256;
constexpr int kManyQueries = 2048;  // from here on, kThreadsMany
constexpr int kStages = 4;   // staged rows per warp
constexpr int kMaxK = 64;    // slots per query (a hit counter is a byte)
constexpr int kMaxDevices = 64;  // devices whose limit is remembered
constexpr uint32_t kFill = 0xFFFFFFFFu;

template <int kThreads>
__global__ void __launch_bounds__(kThreads) fused_and_kernel(
    const uint32_t* __restrict__ blocks, int stride, int pitch,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ k_valid, int K, int L, int P,
    uint32_t* __restrict__ out, int32_t* __restrict__ out_count) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_row[kMaxK];    // first arena row of each slot's list
  __shared__ int s_n[kMaxK];      // its count
  __shared__ int s_first[kMaxK];  // first block of the span in range
  __shared__ int s_start[kMaxK + 1];  // spans' offsets in the flat work
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_items;
  __shared__ int s_warp[kWarps];
  uint32_t* base = smem;            // L decoded base values
  uint32_t* hits = base + L;        // L hit counters, one byte each
  uint32_t* rings = hits + L / 4;   // kWarps x kStages rows of `pitch` words
  int4* items = reinterpret_cast<int4*>(rings + kWarps * kStages * pitch);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t q = blockIdx.x;
  uint32_t* ring = rings + warp * kStages * pitch;

  if (tid < K) {
    s_row[tid] = rows[q * K + tid];
    s_n[tid] = max(counts[q * K + tid], 0);
  }
  // the words past the stride stay zero for the CTA's whole life
  for (int s = 0; s < kStages; ++s) {
    for (int i = stride + lane; i < pitch; i += 32) ring[s * pitch + i] = 0u;
  }
  for (int w = tid; w < L / 4; w += kThreads) hits[w] = 0u;
  if (tid == 0) s_items = 0;
  __syncthreads();
  // a k_valid above K walks K slots, as the plain version's loop does
  const int kv = min(max(k_valid[q], 0), K);
  const int nbv = min(s_n[0], L);  // base values in the window
  const int nb0 = (nbv + tpi::kBlock - 1) / tpi::kBlock;

  // One (probe, block) pair of the flat work: block b of slot j, its anchor
  // a0 and, unless it is the list's last block, the next block's anchor a1.
  struct Pair {
    int j, b;
    uint32_t a0, a1;
    bool last;
  };
  auto read_pair = [&](int j, int b) {
    const uint32_t* row =
        blocks + (static_cast<int64_t>(s_row[j]) + b) * stride;
    Pair p{j, b, __ldg(row + 1), 0u, (b + 1) * tpi::kBlock >= s_n[j]};
    if (!p.last) p.a1 = __ldg(row + stride + 1);
    return p;
  };
  // the usual query: every probe block gets a thread, and its anchors are
  // asked for now, ahead of the base's rows
  int all_blocks = 0;
  for (int j = 1; j < kv; ++j) {
    all_blocks += (s_n[j] + tpi::kBlock - 1) / tpi::kBlock;
  }
  const bool fast = all_blocks <= kThreads;
  Pair mine{0, 0, 0u, 0u, true};
  if (fast && nbv > 0 && tid < all_blocks) {
    int j = 1, b = tid;
    for (;; ++j) {
      const int nbj = (s_n[j] + tpi::kBlock - 1) / tpi::kBlock;
      if (b < nbj) break;
      b -= nbj;
    }
    mine = read_pair(j, b);
  }

  {  // the base's rows: block b to warp b mod kWarps
    const uint32_t* first = blocks + static_cast<int64_t>(s_row[0]) * stride;
    const int m = nb0 > warp ? (nb0 - warp + kWarps - 1) / kWarps : 0;
    tpi::decode_rows_staged<kStages>(
        ring, pitch, stride, lane, m,
        [&](int k) {
          return first + static_cast<int64_t>(warp + k * kWarps) * stride;
        },
        [&](int k, const uint32_t v[4]) {
          reinterpret_cast<uint4*>(base + (warp + k * kWarps) * tpi::kBlock)
              [lane] = make_uint4(v[0], v[1], v[2], v[3]);
        });
  }
  __syncthreads();

  if (nbv > 0 && kv > 1) {
    const uint32_t bmin = base[0];
    const uint32_t bmax = base[nbv - 1];
    int total = all_blocks;
    if (!fast) {
      // per probe, the span of blocks that [bmin, bmax] can reach: from the
      // block before the first anchor above bmin to the last anchor <= bmax
      for (int j = 1 + warp; j < kv; j += kWarps) {
        const int nbj = (s_n[j] + tpi::kBlock - 1) / tpi::kBlock;
        int above_min, above_max;
        tpi::warp_bounds<true, true>(
            blocks + static_cast<int64_t>(s_row[j]) * stride + 1, stride, nbj,
            bmin, bmax, lane, &above_min, &above_max);
        if (lane == 0) {
          s_first[j] = max(above_min - 1, 0);
          // the span's length, for now
          s_start[j + 1] = max(above_max - s_first[j], 0);
        }
      }
      __syncthreads();
      if (tid == 0) {
        int sum = 0;
        for (int j = 1; j < kv; ++j) {
          const int len = s_start[j + 1];
          s_start[j] = sum;
          sum += len;
        }
        s_start[kv] = sum;
      }
      __syncthreads();
      total = s_start[kv];
    }
    int done = 0;  // work items of earlier chunks; s_items only grows

    for (int c0 = 0; c0 < total; c0 += kThreads) {  // uniform across the CTA
      const int it = c0 + tid;
      if (it < total) {
        Pair p = mine;
        if (!fast) {
          int j = 1;
          while (it >= s_start[j + 1]) ++j;
          p = read_pair(j, s_first[j] + it - s_start[j]);
        }
        const int plo = tpi::lower_bound(base, 0, nbv, p.a0);
        const int phi =
            p.last ? nbv : tpi::lower_bound(base, plo, nbv, p.a1);
        if (plo < phi) {
          items[atomicAdd(&s_items, 1) - done] = make_int4(
              s_row[p.j] + p.b,
              min(tpi::kBlock, s_n[p.j] - p.b * tpi::kBlock), plo, phi);
        }
      }
      __syncthreads();
      const int n = s_items - done;
      done += n;
      const int m = n > warp ? (n - warp + kWarps - 1) / kWarps : 0;
      tpi::decode_rows_staged<kStages>(
          ring, pitch, stride, lane, m,
          [&](int k) {
            return blocks +
                   static_cast<int64_t>(items[warp + k * kWarps].x) * stride;
          },
          [&](int k, const uint32_t v[4]) {
            const int4 item = items[warp + k * kWarps];
            int p = item.z;
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // a lane's values ascend with i
              if (4 * lane + i < item.y) {
                p = tpi::lower_bound(base, p, item.w, v[i]);
                if (p < item.w && base[p] == v[i]) {
                  atomicAdd(&hits[p >> 2], 1u << (8 * (p & 3)));
                }
              }
            }
          });
      __syncthreads();  // the work list is refilled by the next chunk
    }
  }

  // position p is kept when every probe hit it (none asked with kv <= 1)
  const uint32_t need = kv > 1 ? static_cast<uint32_t>(kv - 1) : 0u;
  const uint4* base4 = reinterpret_cast<const uint4*>(base);
  int kept = 0;     // masked: this thread's kept; compact: the row's so far
  if (P == 0) {
    uint4* orow = reinterpret_cast<uint4*>(out + q * static_cast<int64_t>(L));
    for (int g = tid; g < L / 4; g += kThreads) {
      const uint32_t h = hits[g];
      const uint4 x = base4[g];
      const bool k0 = 4 * g < nbv && (h & 0xFFu) == need;
      const bool k1 = 4 * g + 1 < nbv && ((h >> 8) & 0xFFu) == need;
      const bool k2 = 4 * g + 2 < nbv && ((h >> 16) & 0xFFu) == need;
      const bool k3 = 4 * g + 3 < nbv && (h >> 24) == need;
      orow[g] = make_uint4(k0 ? x.x : kFill, k1 ? x.y : kFill,
                           k2 ? x.z : kFill, k3 ? x.w : kFill);
      kept += k0 + k1 + k2 + k3;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      kept += __shfl_down_sync(0xFFFFFFFFu, kept, d);
    }
    if (lane == 0) s_warp[warp] = kept;
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
      out_count[q] = sum;
    }
    return;
  }

  uint32_t* orow = out + q * static_cast<int64_t>(P);
  for (int g0 = 0; g0 * 4 < nbv; g0 += kThreads) {  // 4 positions a thread
    const int g = g0 + tid;
    uint32_t x[4] = {0u, 0u, 0u, 0u};
    bool k[4] = {false, false, false, false};
    if (g * 4 < nbv) {
      const uint32_t h = hits[g];
      const uint4 b4 = base4[g];
      x[0] = b4.x, x[1] = b4.y, x[2] = b4.z, x[3] = b4.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        k[i] = 4 * g + i < nbv && ((h >> (8 * i)) & 0xFFu) == need;
      }
    }
    const int c = k[0] + k[1] + k[2] + k[3];
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int y = s_warp[w];
      before += w < warp ? y : 0;
      total += y;
    }
    int pos = kept + before + incl - c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k[i]) {
        if (pos < P) orow[pos] = x[i];
        ++pos;
      }
    }
    kept += total;
    __syncthreads();  // s_warp is reused by the next round
  }
  for (int i = kept + tid; i < P; i += kThreads) orow[i] = kFill;
  if (tid == 0) out_count[q] = kept;
}

template <int kThreads>
int launch(const void* blocks, int stride, const void* rows,
           const void* counts, const void* k_valid, int Q, int K, int L, int P,
           void* out, void* out_count, cudaStream_t stream) {
  const int pitch = stride > tpi::kMaxRowWords ? stride : tpi::kMaxRowWords;
  const int smem =
      (L + L / 4 + (kThreads / 32) * kStages * pitch) *
          static_cast<int>(sizeof(uint32_t)) +
      kThreads * static_cast<int>(sizeof(int4));
  // The limit on dynamic shared memory belongs to the function on one
  // device: raised once per device and size, not per launch.
  static std::mutex mu;
  static int allowed_smem[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  {
    const std::lock_guard<std::mutex> lock(mu);
    if (!cached || smem > allowed_smem[dev]) {
      err = cudaFuncSetAttribute(fused_and_kernel<kThreads>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (cached) allowed_smem[dev] = smem;
    }
  }
  fused_and_kernel<kThreads><<<Q, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(blocks), stride, pitch,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(k_valid), K, L, P,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(out_count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (rows, stride) with stride % 4 == 0 and 16-byte-aligned rows;
// rows/counts (Q, K) int32, k_valid (Q,) int32, out_count (Q,) int32;
// L % 128 == 0. P = 0: out is the masked (Q, L) matrix (16-byte-aligned
// rows); P > 0: out is (Q, P), the first P kept values of each row. About
// 5.25 L bytes + 21 KiB of shared memory must fit the card. Returns the first
// CUDA error, or 0.
extern "C" int tpi_fused_and(const void* blocks, int stride, const void* rows,
                             const void* counts, const void* k_valid, int Q,
                             int K, int L, int P, void* out, void* out_count,
                             void* stream) {
  if (Q == 0) return 0;
  if (stride < 4 || stride % 4 != 0 || K < 1 || K > kMaxK ||
      L % tpi::kBlock != 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (Q >= kManyQueries) {
    return launch<kThreadsMany>(blocks, stride, rows, counts, k_valid, Q, K, L,
                                P, out, out_count, st);
  }
  return launch<kThreadsFew>(blocks, stride, rows, counts, k_valid, Q, K, L, P,
                             out, out_count, st);
}
