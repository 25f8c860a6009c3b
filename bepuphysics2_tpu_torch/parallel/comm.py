"""Collectives over a ``torch.distributed`` process group, the port's form of the JAX
package's mesh-axis primitives: a rank owns one shard, ``psum`` / ``pmin`` / ``pmax``
become ``all_reduce`` with SUM / MIN / MAX, and the tiled ``all_gather`` along the leading
axis becomes ``all_gather_into_tensor``. ``group=None`` never reaches here: the callers
run their unsharded code then. A group of one rank needs no communication, and none is
issued. Boolean tensors travel as uint8 (not every backend reduces or gathers bool).
``calls`` counts the collectives issued, for the smoke run's per-step count.
"""
from __future__ import annotations

import torch

calls = 0


def _dist():
    import torch.distributed as dist

    return dist


def rank(group) -> int:
    return _dist().get_rank(group)


def world_size(group) -> int:
    return _dist().get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis, in rank order (JAX
    ``all_gather(..., axis=0, tiled=True)``)."""
    global calls
    if world_size(group) == 1:
        return x
    dist = _dist()
    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = torch.empty((world_size(group) * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    calls += 1
    return out.bool() if x.dtype == torch.bool else out


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    global calls
    if world_size(group) == 1:
        return x
    dist = _dist()
    y = (x.to(torch.int32) if x.dtype == torch.bool else x).clone().contiguous()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=group)
    calls += 1
    return y.bool() if x.dtype == torch.bool else y


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _reduce(x, "SUM", group)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    return _reduce(x, "MIN", group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _reduce(x, "MAX", group)
