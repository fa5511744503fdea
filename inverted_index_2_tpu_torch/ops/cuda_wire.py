"""The device half of the full-result wire codec on the card (csrc/wire.cu):
the masked max delta that picks the wire's width, and the first value plus
delta pack.

Replaces no TPU kernel. models/steps.py::_wire_meta_step and
_wire_pack_step are both steps as plain torch ops, as the JAX package has
them as plain XLA; on the card they were some 20 int64 torch launches over
every lane of a result matrix, where only each row's first `oc` lanes
count. Here each is one launch that reads the kept lanes alone (the meta)
or the widest row's lanes (the pack). The wire format and the width rule
are the plain steps', bit for bit.

`wire_meta` and `wire_pack` take their plain versions only for tensors on
the CPU; for CUDA tensors they launch the kernels or raise. Both devices
keep one contract. Each counts its kernel launches on the card in
`.launches`.
"""
from __future__ import annotations

import torch

from ..models.steps import _wire_meta_step, _wire_pack_step
from . import _build


def _pitch(o: torch.Tensor) -> int:
    """The row pitch of o (n, S) int32 u32 bits, whose lanes must be
    contiguous (rows may sit at any pitch)."""
    if o.dtype != torch.int32 or o.dim() != 2:
        raise ValueError(f"o: want int32 (n, S), got {o.dtype} with shape "
                         f"{tuple(o.shape)}")
    if o.shape[1] > 1 and o.stride(1) != 1:
        raise ValueError(f"o: lanes at a stride of {o.stride(1)}; the wire "
                         "kernels take a row pitch and contiguous lanes")
    return o.stride(0) if o.shape[0] > 1 else o.shape[1]


def wire_meta(o: torch.Tensor, oc: torch.Tensor) -> torch.Tensor:
    """Masked max result delta of a result matrix o (n, S) u32 bits with
    row counts oc (n,) int32 or int64: the max over rows of
    (o[r, i+1] - o[r, i]) mod 2^32 for i < oc[r] - 1, an int64 0-d tensor
    (0 where no row has two values). See steps._wire_meta_step."""
    pitch = _pitch(o)
    n, S = o.shape
    if (oc.dtype not in (torch.int32, torch.int64) or oc.shape != (n,)
            or oc.device != o.device):
        raise ValueError(f"oc: want ({n},) int32 or int64 on {o.device}, got "
                         f"{oc.dtype} {tuple(oc.shape)} on {oc.device}")
    dev = o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no wire meta kernel for device {dev}")
    if n == 0 or S < 2:
        return torch.zeros((), dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        return _wire_meta_step(o, oc)
    oc = oc.contiguous()
    md = torch.empty((), dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tpi_wire_meta(
            o.data_ptr(), pitch, n, S, oc.data_ptr(),
            1 if oc.dtype == torch.int64 else 0, md.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tpi_wire_meta")
    wire_meta.launches += 1
    return md


def wire_pack(o: torch.Tensor, bits: int, maxc: int):
    """(first (n, 1) int32 u32 bits, deltas (n, maxc - 1) uint8 at bits 8
    or int16 bits of u16 at bits 16), both contiguous: the wire of the
    first maxc lanes of each row of o (n, S), 1 <= maxc <= S. Deltas past
    a row's own count may wrap; the host trims them. See
    steps._wire_pack_step."""
    pitch = _pitch(o)
    n, S = o.shape
    if bits not in (8, 16):
        raise ValueError(f"bits={bits}: the wire packs 8 or 16 bits")
    if not 1 <= maxc <= S:
        raise ValueError(f"maxc={maxc}: want 1 <= maxc <= {S} (the row width)")
    dev = o.device
    if dev.type == "cpu":
        return _wire_pack_step(o[:, :maxc], bits)
    if dev.type != "cuda":
        raise ValueError(f"no wire pack kernel for device {dev}")
    first = torch.empty((n, 1), dtype=torch.int32, device=dev)
    dd = torch.empty((n, maxc - 1),
                     dtype=torch.uint8 if bits == 8 else torch.int16,
                     device=dev)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.tpi_wire_pack(
                o.data_ptr(), pitch, n, maxc - 1, bits, first.data_ptr(),
                dd.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "tpi_wire_pack")
        wire_pack.launches += 1
    return first, dd


wire_meta.launches = 0  # kernel launches in this process, one a call
wire_pack.launches = 0  # kernel launches in this process, one a call
