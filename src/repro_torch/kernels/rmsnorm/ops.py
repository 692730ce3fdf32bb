"""Dispatch wrapper for the fused (residual +) RMSNorm.

Called from ``models/layers.rms_norm`` when ``CallConfig.use_pallas_norm``
is set: twice per layer and once for the final norm, in prefill and in
decode. It flattens the leading dims to the kernel's ``[N, D]`` and picks
the backend by the rule of ``kernels/_dispatch.py`` (``"auto"``: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors; no fallback).
A DTensor ``x`` runs on each device's rows (``placements``) through
``local_map``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _dispatch
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
            residual: Optional[torch.Tensor] = None,
            backend: str = "auto") -> torch.Tensor:
    """x: [..., D], w: [D]. Residual add, statistics and the multiply by w
    in fp32; output in x.dtype."""
    if _dispatch.is_dtensor(x):
        pl = placements(x)
        rest = () if residual is None else (residual,)

        def local(x, w, *r):
            return rmsnorm(x, w, eps=eps, residual=r[0] if r else None,
                           backend=backend)

        return _dispatch.local_call(local, (x, w, *rest),
                                    (pl, _replicated(pl), *(pl,) * len(rest)),
                                    pl)
    if _dispatch.resolve_backend(backend, x.device, "rmsnorm") == "ref":
        return rmsnorm_ref(x, w, eps=eps, residual=residual)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    r2 = (None if residual is None
          else residual.reshape(-1, shape[-1]).contiguous())
    return kernel.rmsnorm_cuda(x2, w, eps=eps, residual=r2).reshape(shape)


def _replicated(pl: tuple) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(pl)


def placements(x) -> tuple:
    """Where a DTensor ``x`` [..., D] can be normalized locally: its row
    dims stay sharded, a shard of D is gathered (redistributed to
    Replicate on that mesh dim), a pending sum is reduced; w is
    replicated."""
    from torch.distributed.tensor import Replicate
    keep = [p if _dispatch.shard_dim(p) is not None
            and _dispatch.shard_dim(p) < x.dim() - 1 else Replicate()
            for p in x.placements]
    return tuple(_dispatch.even_shards(x, keep))
