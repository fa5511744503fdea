"""Kernel K2: fused decode + AND over the block arena (csrc/fused_and.cu),
with its plain torch version and the smallest-list-first reorder.

Replaces inverted_index_2_tpu/ops/pallas_fused.py::fused_and_pallas. Bound
on the card by few bytes (the base's rows, the probe blocks whose range
holds a base value, the output); what the design fights is the chain of
dependent reads in front of each block (see the kernel's header). The base
list is held in shared memory, 4*L bytes, which caps the ladder levels K2
serves at MAX_LEVEL; a base list above it goes to the exact concat AND
(ops/concat_bool.py).

The kernel has a masked and a compact output. The TPU kernel could only
mask, and its callers compacted afterwards (a row sort, or P masked
minima); those stay as the plain versions (`compact_rows`,
`compact_small`) and run on the CPU only.

`fused_and` takes the plain versions only for tensors on the CPU; for CUDA
tensors it launches K2 or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .cuda_decode import _check_int32
from .compaction import compact_rows
from .decode import BLOCK, decode_lists
from ..utils.u32 import MASK32, SENT, flip, from_i64

MAX_LEVEL = 16384       # largest L K2 takes: a 64 KiB base in shared memory
MAX_K = 64              # slots per query the kernel takes (kMaxK)
_PLAIN_BUDGET = 1 << 22  # values per probe matrix in the plain version
_PAST_END = 1 << 33     # probe lanes past the count: above every u32


def reorder_smallest_base(rows: torch.Tensor, counts: torch.Tensor,
                          k_valid: torch.Tensor):
    """Swap each query's smallest-count active slot into slot 0.

    Missing terms carry count 0 and win, so an empty base empties the AND.
    Slots at or past k_valid are excluded. Returns (rows', counts', need),
    need being the base count: the only count whose excess over L forces a
    ladder re-serve."""
    K = rows.shape[1]
    cols = torch.arange(K, dtype=torch.int64, device=rows.device)[None, :]
    kmask = cols < k_valid.to(torch.int64)[:, None]
    guarded = torch.where(kmask, counts, torch.full_like(counts, 0x7FFFFFFF))
    b = torch.argmin(guarded, dim=1)[:, None]
    perm = torch.where(cols == 0, b, torch.where(cols == b, 0, cols))
    rows2 = rows.gather(1, perm)
    counts2 = counts.gather(1, perm)
    need = torch.where(k_valid > 0, counts2[:, 0], 0).to(torch.int32)
    return rows2, counts2, need


def _fused_and_chunk(blocks, rows, cnt, kv, L: int):
    Q, K = rows.shape
    dev = blocks.device
    base = decode_lists(blocks, rows[:, 0], cnt[:, 0], L)
    keep = torch.arange(L, device=dev)[None, :] < cnt[:, :1]
    for j in range(1, K):
        active = (kv > j)[:, None]
        nj = cnt[:, j]
        longest = int(torch.where(active[:, 0], nj, 0).max())
        if longest == 0:  # every active probe is empty
            keep &= ~active
            continue
        M = -(-longest // BLOCK) * BLOCK
        pv = decode_lists(blocks, rows[:, j], nj, M)
        pv = torch.where(torch.arange(M, device=dev)[None, :] < nj[:, None],
                         pv, _PAST_END)
        pos = torch.searchsorted(pv, base).clamp(max=M - 1)
        keep &= (pv.gather(1, pos) == base) | ~active
    out = torch.where(keep, base, MASK32)
    return from_i64(out), keep.sum(dim=1).to(torch.int32)


def fused_and_torch(blocks, rows, counts, k_valid, L: int):
    """Plain version of K2: (masked (Q, L) u32 bits, keep counts (Q,)).
    Every probe list is decoded in full and searched with searchsorted;
    queries go in chunks so the probe matrices stay bounded."""
    Q, K = rows.shape
    cnt = counts.to(torch.int64)
    kv = k_valid.to(torch.int64)
    out = torch.empty((Q, L), dtype=torch.int32, device=blocks.device)
    oc = torch.empty(Q, dtype=torch.int32, device=blocks.device)
    if Q == 0:
        return out, oc
    longest = max(L, int(cnt[:, 1:].max()) if K > 1 else 0)
    step = max(1, _PLAIN_BUDGET // longest)
    for c0 in range(0, Q, step):
        sl = slice(c0, c0 + step)
        out[sl], oc[sl] = _fused_and_chunk(blocks, rows[sl], cnt[sl], kv[sl], L)
    return out, oc


def compact_small(flat: torch.Tensor, P: int) -> torch.Tensor:
    """First P ascending values of each row of a masked fused output ->
    (Q, P): the plain version of K2's compact output of width P. The kept
    values of a row are distinct and everything else is 0xFFFFFFFF, so this
    equals the JAX step's P iterative masked mins."""
    return flip(torch.topk(flip(flat), P, dim=1, largest=False).values)


def fused_and(blocks: torch.Tensor, rows: torch.Tensor, counts: torch.Tensor,
              k_valid: torch.Tensor, L: int, compact: bool = True,
              width: int = 0):
    """AND over arena-resident lists. rows/counts (Q, K) int32 with slot 0
    the smallest list (reorder_smallest_base), 0 for missing terms;
    k_valid (Q,) int32. Probe lists are walked to their full length; only a
    base count over L needs a re-serve. Returns (vals, oc (Q,) int32 the
    number of members). vals holds u32 bits:
      compact=False    (Q, L) masked: members in place, 0xFFFFFFFF elsewhere;
      compact=True     (Q, L): the members ascending at the front, then
                       0xFFFFFFFF, so a row's first oc values are the result;
      width=P (0 < P <= L)  (Q, P): the first P members ascending, then
                       0xFFFFFFFF; oc stays the full count.
    On the card one kernel gives each of them. A genuine 0xFFFFFFFF member,
    the largest u32 and so the last member of its row, has the fill's bits
    and lands where the fill would: the plain compactions, which cannot tell
    it from the fill, give the same rows."""
    if L % BLOCK or not 0 < L <= MAX_LEVEL:
        raise ValueError(f"L={L}: want a multiple of {BLOCK} in "
                         f"(0, {MAX_LEVEL}]")
    if not 0 <= width <= L:
        raise ValueError(f"width={width}: want 0 (off) or 1..L={L}")
    dev = blocks.device
    if dev.type == "cpu":
        out, oc = fused_and_torch(blocks, rows, counts, k_valid, L)
        if width:
            out = compact_small(out, width)
        elif compact:
            out = compact_rows(out, out != SENT)
        return out, oc
    if dev.type != "cuda":
        raise ValueError(f"no K2 kernel for device {dev}")
    _check_int32("blocks", blocks, 2, dev)
    _check_int32("rows", rows, 2, dev)
    _check_int32("counts", counts, 2, dev)
    _check_int32("k_valid", k_valid, 1, dev)
    Q, K = rows.shape
    if counts.shape != rows.shape or k_valid.shape[0] != Q:
        raise ValueError("rows/counts/k_valid shapes disagree")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K}: want 1 <= K <= {MAX_K}")
    if blocks.shape[1] % 4 or blocks.data_ptr() % 16:
        raise ValueError("blocks: K2 wants 16-byte-aligned arena rows "
                         f"(stride {blocks.shape[1]} words)")
    P = width or (L if compact else 0)  # 0: the masked output
    out = torch.empty((Q, P or L), dtype=torch.int32, device=dev)
    oc = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.tpi_fused_and(
                blocks.data_ptr(), blocks.shape[1], rows.data_ptr(),
                counts.data_ptr(), k_valid.data_ptr(), Q, K, L, P,
                out.data_ptr(), oc.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "tpi_fused_and")
        fused_and.launches += 1
        fused_and.entries["width" if width else
                          "compact" if compact else "masked"] += 1
    return out, oc


fused_and.launches = 0  # K2 launches in this process
fused_and.entries = {"masked": 0, "compact": 0, "width": 0}  # by output
