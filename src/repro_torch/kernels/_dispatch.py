"""Backend choice shared by every kernel's ops module.

  ``"auto"`` — the CUDA kernel for tensors on a CUDA device, the plain
               PyTorch version (``ref.py``) for tensors on the CPU;
  ``"ref"``  — the plain version on any device;
  ``"cuda"`` — the kernel; raises for tensors on the CPU.

The choice follows the device only. A build or launch error raises; there
is no fallback from a kernel to its plain version.
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "ref", "cuda")


def resolve_backend(backend: str, device: torch.device, what: str) -> str:
    """"ref" or "cuda" for ``what``'s tensors on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}; "
                         f"one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"{what} backend 'cuda' needs tensors on a CUDA "
                         f"device, got {device}")
    return backend


# ---- DTensor inputs: the kernels run on each device's own shards ----------
#
# The kernels take raw pointers (ctypes), so a DTensor never reaches one:
# under a mesh a wrapper picks, mesh dim by mesh dim, placements its kernel
# can work on locally, redistributes the inputs to them (a collective where
# a placement changes, said at each call site) and runs the kernel's
# wrapper on the local shards through ``local_map``.

def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def shard_dim(placement):
    """The tensor dim a placement shards, or None (Replicate, Partial)."""
    from torch.distributed.tensor import Shard
    return placement.dim if isinstance(placement, Shard) else None


def local_call(fn, args: tuple, in_placements: tuple, out_placements):
    """``fn(*local shards)`` as DTensors: each DTensor of ``args`` is
    redistributed to its entry of ``in_placements`` (a sequence of
    placements a mesh dim, or None for a non-tensor argument) and ``fn``
    runs on the local shards; its outputs take ``out_placements`` (one
    output's placements, or a sequence of them for a tuple). The
    gradient of an input that is replicated over a mesh dim on which
    another input is sharded is a partial sum (each device saw its own
    shard), so it is marked ``Partial``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    n_mesh = len(next(p for p in in_placements if p is not None))
    sharded = [any(p is not None and shard_dim(p[m]) is not None
                   for p in in_placements) for m in range(n_mesh)]
    grads = tuple(None if p is None else tuple(
        Partial() if sharded[m] and isinstance(p[m], Replicate) else p[m]
        for m in range(n_mesh)) for p in in_placements)
    from torch.distributed.tensor import Placement
    if all(isinstance(p, Placement) for p in out_placements):
        outs = list(out_placements)            # one output
    else:
        outs = tuple(list(p) for p in out_placements)
    return local_map(fn, out_placements=outs, in_placements=in_placements,
                     in_grad_placements=grads,
                     redistribute_inputs=True)(*args)


def even_shards(t, choice: list) -> list:
    """``choice`` (a placement a mesh dim, for tensor ``t``) with every
    ``Shard(d)`` whose dim does not split evenly over the mesh dims that
    shard it replaced by ``Replicate``: a kernel's local shards must be
    the even chunks ``local_map`` assumes."""
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    ways: dict = {}
    for m, p in enumerate(choice):
        d = shard_dim(p)
        if d is not None:
            ways[d] = ways.get(d, 1) * mesh.size(m)
    return [Replicate() if shard_dim(p) is not None
            and t.shape[shard_dim(p)] % ways[shard_dim(p)] else p
            for p in choice]


def local_span(t, dim: int, placements=None):
    """(first index, length) of this device's shard of DTensor ``t``'s dim
    ``dim`` under ``placements`` (default ``t``'s own; even shards, nested
    in mesh-dim order, as DTensor splits them)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    size, start = t.shape[dim], 0
    for m, p in enumerate(placements or t.placements):
        if shard_dim(p) == dim:
            size //= mesh.size(m)
            start += coord[m] * size
    return start, size


def settled(t):
    """A DTensor with every pending reduction done and no shard
    (Replicate on every mesh dim), else ``t``: a scalar loss term before
    it is combined with others, whose pending reductions may be of
    different kinds (a sum, a mean)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(placements=(Replicate(),) * t.device_mesh.ndim)
