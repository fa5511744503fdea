"""Kernel K3: batched AND of K sorted lists per query (csrc/intersect.cu).

Replaces inverted_index_2_tpu/ops/pallas_bool.py::intersect_pallas, the
TPU twin of ops/setops.py::intersect_many. The AND of the delta tier's
padded dual step (models/steps.py boolean_step_dual) runs through it, as
the port's lookup_step runs K1 where JAX runs its XLA twin. Bound on the
card by the bytes of the valid values it reads and the rows it writes; what
the design fights is the latency of dependent searches (see the kernel's
header): the shortest present list is the base, the probes follow shortest
first, one CTA a query.

`intersect_many` takes the plain version (ops/setops.intersect_many) only
for tensors on the CPU; for CUDA tensors it launches K3 or raises.
"""
from __future__ import annotations

import torch

from . import _build, setops
from .cuda_decode import _check_int32

# the kernel's sizes (csrc/intersect.cu), for scripts that emulate its plan
TILE = 1024          # base values per tile (kTile)
SLOT = 2048          # values in one slot of the staging ring (kSlot)
WHOLE_FIRST = 1024   # a first probe this short is copied whole (kWholeFirst)
DIRECT_RATIO = 32    # a window this many times the tile's base is searched
                     # where it lies (kDirectRatio)
MAX_K = 32           # lists per query the kernel takes (kMaxK)


def intersect_many(lists: torch.Tensor, counts: torch.Tensor,
                   k_valid: torch.Tensor):
    """AND of K sorted lists per query: lists (Q, K, L) u32 bits, each row
    ascending in u32 order and unique within counts (Q, K); k_valid (Q,).
    Returns (vals (Q, L) u32 bits, the kept values ascending then
    0xFFFFFFFF to the end of the row; counts (Q,) int32).

    A row with k_valid = 0 is answered as the plain version answers it at
    this L: its broadcast regime (L * L <= setops._BROADCAST_LIMIT) keeps
    the base's valid prefix, its sort regime gives an empty row, and the
    kernel is told which. The dual step makes such a row only for a query
    of no terms, whose base is the all-zero key's list: empty unless the
    index holds the empty term."""
    dev = lists.device
    if dev.type == "cpu":
        return setops.intersect_many(lists, counts, k_valid)
    if dev.type != "cuda":
        raise ValueError(f"no K3 kernel for device {dev}")
    lists = lists.contiguous()
    counts = counts.to(torch.int32).contiguous()
    k_valid = k_valid.to(torch.int32).contiguous()
    _check_int32("lists", lists, 3, dev)
    _check_int32("counts", counts, 2, dev)
    _check_int32("k_valid", k_valid, 1, dev)
    Q, K, L = lists.shape
    if counts.shape != (Q, K) or k_valid.shape[0] != Q:
        raise ValueError("lists/counts/k_valid shapes disagree")
    if not 1 <= K <= MAX_K or L < 1:
        raise ValueError(f"K={K}, L={L}: want 1 <= K <= {MAX_K} and L >= 1")
    out = torch.empty((Q, L), dtype=torch.int32, device=dev)
    oc = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.tpi_intersect(
                lists.data_ptr(), counts.data_ptr(), k_valid.data_ptr(),
                Q, K, L, int(L * L <= setops._BROADCAST_LIMIT),
                out.data_ptr(), oc.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "tpi_intersect")
        intersect_many.launches += 1
    return out, oc


intersect_many.launches = 0  # K3 launches in this process
