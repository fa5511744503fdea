"""Collectives over lists of per-partition tensors: the single-controller
counterparts of the jax.lax collectives that the JAX mesh runs inside
shard_map (psum, psum_scatter, all_gather, all_to_all).

One process drives every partition. Partition d's tensors live on
devices[d], and several partitions may share a device (D partitions on one
card). A collective takes the list of per-partition tensors, all of one
shape, and returns the list of results, result d on devices[d]. Data moves
by `.to(device, non_blocking=True)` copies (a peer copy between two cards,
nothing between two partitions of one card) and torch ops, so the same code
runs on one card, on several, and on the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True)


def replicate(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """x on every partition's device (one copy per distinct device)."""
    by_dev: Dict[torch.device, torch.Tensor] = {}
    return [by_dev.setdefault(d, _to(x, d)) for d in devices]


def _sum_on(xs: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    acc = _to(xs[0], dev)
    for x in xs[1:]:
        acc = acc + _to(x, dev)
    return acc


def psum(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]
         ) -> List[torch.Tensor]:
    """All-reduce sum: every partition gets the sum of all of them."""
    return replicate(_sum_on(xs, devices[0]), devices)


def psum_scatter(xs: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Reduce-scatter, tiled on axis 0 (its length a multiple of D):
    partition d gets rows [d*Q/D, (d+1)*Q/D) of the sum."""
    D = len(devices)
    Qd = xs[0].shape[0] // D
    return [_sum_on([x[d * Qd:(d + 1) * Qd] for x in xs], devices[d])
            for d in range(D)]


def all_gather(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]
               ) -> List[torch.Tensor]:
    """Every partition gets all of them, stacked: (D, *shape)."""
    return [torch.stack([_to(x, dev) for x in xs]) for dev in devices]


def all_to_all(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
               split_axis: int = 0, concat_axis: int = 1
               ) -> List[torch.Tensor]:
    """Tiled all-to-all: each tensor is cut into D equal chunks along
    split_axis; partition d gets chunk d of every partition, joined along
    concat_axis in partition order."""
    D = len(devices)
    c = xs[0].shape[split_axis] // D
    return [torch.cat([_to(x.narrow(split_axis, d * c, c), devices[d])
                       for x in xs], dim=concat_axis)
            for d in range(D)]
