"""The concat-class step on the card (csrc/concat_step.cu): one decode of
each query's blocks into K4's sort input, K4's row sort, and one run-length
mark plus compaction split across CTAs.

Replaces no TPU kernel. ops/concat_bool.py::boolean_concat_step is the
step as plain torch ops, as the JAX package had it as plain XLA; on the
card that chain was 150-220 torch ops a class chunk, each a host dispatch,
with int64 intermediates of some 250-300 bytes a lane. Here a chunk is
three calls: `concat_decode` (one launch), K4's `sort_rows(run=128)` and
`concat_compact` (three launches: tile counts, a scan of them per row, the
scatter). Both kernels are bound by bytes (see the source's header).

A chunk reads its queries through `rows`, int32 indexes into the batch's
resolved (idx, found, k_valid): the stream uploads its class order once a
batch and hands each chunk a slice of it. The page form writes each row's
first P values and true count straight into the batch's (Q, P+1) buffer.

`concat_decode` and `concat_compact` take their plain versions
(concat_decode_torch, concat_compact_torch) only for tensors on the CPU;
for CUDA tensors they launch the kernels or raise. Both devices keep one
contract, the page form included. Each counts its kernel launches on the
card in `.launches`.
"""
from __future__ import annotations

import torch

from . import _build
from .concat_bool import (
    check_step_args,
    concat_compact_torch,
    concat_decode_torch,
)
from .cuda_decode import _check_int32
from .cuda_sort import sort_rows
from .decode import BLOCK

MARK_TILE = 2048  # lanes one CTA of the compaction marks (kMarkTile)
MAX_K = 4096      # terms a query may have (kMaxK)


def _check_rows(rows: torch.Tensor, dev) -> None:
    if (rows.dtype != torch.int32 or rows.dim() != 1 or rows.device != dev
            or not rows.is_contiguous()):
        raise ValueError("rows: want a contiguous 1-d int32 tensor on "
                         f"{dev}, got {rows.dtype} {tuple(rows.shape)} on "
                         f"{rows.device}")


def concat_decode(blocks, term_block_start, counts, idx, found, k_valid,
                  rows, SB: int):
    """(flat (n, SB*128) u32 bits, meta (4, n) int32) of the queries
    `rows` (n,) int32 of a resolved batch: idx (Q, K), found (Q, K) bool,
    k_valid (Q,). See concat_bool.concat_decode_torch."""
    dev = blocks.device
    if dev.type == "cpu":
        r = rows.to(torch.int64)
        return concat_decode_torch(blocks, term_block_start, counts, idx[r],
                                   found[r], k_valid[r], SB)
    if dev.type != "cuda":
        raise ValueError(f"no concat decode kernel for device {dev}")
    _check_int32("blocks", blocks, 2, dev)
    _check_int32("term_block_start", term_block_start, 1, dev)
    _check_int32("counts", counts, 1, dev)
    _check_rows(rows, dev)
    Q, K = idx.shape
    stride = blocks.shape[1]
    if stride % 4 or blocks.data_ptr() % 16:
        raise ValueError("blocks: the concat decode wants 16-byte-aligned "
                         f"arena rows (stride {stride} words)")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K}: the concat decode takes 1 to {MAX_K} terms")
    if SB < 1 or SB * BLOCK >= 1 << 30:
        raise ValueError(f"SB={SB}: want 1 <= SB * 128 < 2^30")
    if idx.dtype != torch.int64:
        idx = idx.to(torch.int64)
    if k_valid.dtype != torch.int32:
        k_valid = k_valid.to(torch.int32)
    idx, found, k_valid = (t.contiguous() for t in (idx, found, k_valid))
    for name, t in (("idx", idx), ("found", found), ("k_valid", k_valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the arena on {dev}")
    if found.dtype != torch.bool or found.shape != (Q, K) \
            or k_valid.shape != (Q,):
        raise ValueError(f"found {found.dtype} {tuple(found.shape)} and "
                         f"k_valid {tuple(k_valid.shape)}: want ({Q}, {K}) "
                         f"bool and ({Q},)")
    n = rows.shape[0]
    flat = torch.empty((n, SB * BLOCK), dtype=torch.int32, device=dev)
    meta = torch.empty((4, n), dtype=torch.int32, device=dev)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.tpi_concat_decode(
                blocks.data_ptr(), stride, term_block_start.data_ptr(),
                counts.data_ptr(), idx.data_ptr(), found.data_ptr(),
                k_valid.data_ptr(), K, rows.data_ptr(), n, SB,
                flat.data_ptr(), meta.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "tpi_concat_decode")
        concat_decode.launches += 1
    return flat, meta


def concat_compact(svals, meta, op: str, K: int, prefix_p: int = 0,
                   obuf=None, rows=None):
    """The run-length marks over the sorted rows svals (n, S) and the kept
    lanes compacted: (out, oc) as boolean_concat_step returns them (see
    concat_bool.concat_compact_torch). prefix_p takes the page form: `obuf`
    (the batch's (Q, P+1) buffer, P = prefix_p, OR) gets, in row rows[i],
    the first P values and then the true count, and the call returns None."""
    dev = svals.device
    P = int(prefix_p)
    if P and obuf is None:
        raise ValueError("prefix_p takes the page form: pass obuf")
    if obuf is not None:
        _check_int32("obuf", obuf, 2, dev)
        _check_rows(rows, dev)
        if op != "or" or P < 1 or obuf.shape[1] != P + 1 \
                or rows.shape != (svals.shape[0],):
            raise ValueError("the page form is OR with prefix_p = P into a "
                             f"(Q, P+1) buffer at n rows, got op={op!r}, "
                             f"P={P}, obuf {tuple(obuf.shape)}, rows "
                             f"{tuple(rows.shape)}")
    if dev.type == "cpu":
        return concat_compact_torch(svals, meta, op, K, P, obuf, rows)
    if dev.type != "cuda":
        raise ValueError(f"no concat compaction kernel for device {dev}")
    _check_int32("svals", svals, 2, dev)
    _check_int32("meta", meta, 2, dev)
    n, S = svals.shape
    if meta.shape != (4, n):
        raise ValueError(f"meta {tuple(meta.shape)}: want (4, {n})")
    W = min(S, P * K)
    out = oc = None
    if obuf is None:
        out = torch.empty((n, S), dtype=torch.int32, device=dev)
        oc = torch.empty(n, dtype=torch.int32, device=dev)
    if n and S:
        tiles = -(-S // MARK_TILE)
        cnt = torch.empty((n, tiles + 1), dtype=torch.int32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.tpi_concat_compact(
                svals.data_ptr(), S, meta.data_ptr(), n, K,
                1 if op == "and" else 0, cnt.data_ptr(),
                None if out is None else out.data_ptr(),
                None if oc is None else oc.data_ptr(),
                None if rows is None else rows.data_ptr(),
                None if obuf is None else obuf.data_ptr(), W, P,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "tpi_concat_compact")
        concat_compact.launches += 3  # tile counts, row scans, scatter
    if obuf is not None:
        return None
    return out, oc


def concat_step(blocks, term_block_start, counts, idx, found, k_valid,
                rows, SB: int, op: str, prefix_p: int = 0,
                wire_dedup: bool = False, obuf=None):
    """boolean_concat_step over the queries `rows` (n,) int32 of a resolved
    batch (idx (Q, K), found (Q, K), k_valid (Q,)): concat_decode, K4's sort
    from runs of 128, then concat_compact (wire_dedup: the sorted stream
    and n_valid, nothing compacted). prefix_p takes `obuf` and returns
    None: see concat_compact."""
    check_step_args(op, prefix_p, wire_dedup)
    if obuf is not None and (wire_dedup or not prefix_p):
        raise ValueError("obuf takes the page form (prefix_p > 0)")
    flat, meta = concat_decode(blocks, term_block_start, counts, idx, found,
                               k_valid, rows, SB)
    svals = sort_rows(flat, run=BLOCK)
    if wire_dedup:
        return svals, meta[0]
    return concat_compact(svals, meta, op, idx.shape[1], prefix_p, obuf,
                          rows)


concat_decode.launches = 0   # kernel launches in this process, one a call
concat_compact.launches = 0  # kernel launches in this process, three a call
