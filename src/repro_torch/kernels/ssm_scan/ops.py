"""Dispatch wrapper for the selective scan.

Called from ``models/ssm.mamba_ssm`` when ``use_kernel`` (the reference's
``ssm.py:76-78``), once per ``mamba_forward``. It picks the backend by the
rule of ``kernels/_dispatch.py`` (``"auto"``: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors; no fallback). The plain
version ends in the kernel's order (``ref.ssm_scan_kernel_order``: D*x
added in fp32, one cast to x.dtype), so the result's dtype and rounding
do not depend on the device. The reference's ``bd`` and ``chunk`` knobs
have no counterpart: the kernel takes any S and Di as they are.
DTensor inputs run on each device's batch rows or channels
(``placements``) through ``local_map``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dispatch
from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_kernel_order


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
             backend: str = "auto") -> torch.Tensor:
    """x, dt: [Bt, S, Di]; B, C: [Bt, S, N]; A: [Di, N]; D: [Di]."""
    if _dispatch.is_dtensor(x):
        def local(*args):
            return ssm_scan(*args, backend=backend)

        pl = placements(x)
        return _dispatch.local_call(local, (x, dt, B, C, A, D), pl, pl[0])
    if _dispatch.resolve_backend(backend, x.device, "ssm_scan") == "ref":
        return ssm_scan_kernel_order(x, dt, B, C, A, D)
    return kernel.ssm_scan_cuda(x.contiguous(), dt.contiguous(),
                                B.contiguous(), C.contiguous(), A, D)


def placements(x) -> tuple:
    """Placements of (x, dt, B, C, A, D) for a local scan of a DTensor x
    [Bt, S, Di]: mesh dim by mesh dim, x's batch shard (x, dt, B, C on
    dim 0) or channel shard (x, dt on dim 2; A, D on dim 0; B, C whole)
    is kept; a shard of S (the recurrence runs along it) or a pending sum
    is gathered first."""
    from torch.distributed.tensor import Replicate, Shard
    keep = [p if _dispatch.shard_dim(p) in (0, 2) else Replicate()
            for p in x.placements]
    keep = _dispatch.even_shards(x, keep)
    r = Replicate()
    per = {0: (Shard(0),) * 4 + (r, r), 2: (Shard(2), Shard(2), r, r,
                                            Shard(0), Shard(0))}
    cols = [per.get(_dispatch.shard_dim(p), (r,) * 6) for p in keep]
    return tuple(tuple(c[i] for c in cols) for i in range(6))
