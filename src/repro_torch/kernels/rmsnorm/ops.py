"""Dispatch wrapper for the fused (residual +) RMSNorm.

Called from ``models/layers.rms_norm`` when ``CallConfig.use_pallas_norm``
is set: twice per layer and once for the final norm, in prefill and in
decode. It flattens the leading dims to the kernel's ``[N, D]`` and picks
the backend by the rule of ``kernels/_dispatch.py`` (``"auto"``: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors; no fallback).
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
    if _dispatch.resolve_backend(backend, x.device, "rmsnorm") == "ref":
        return rmsnorm_ref(x, w, eps=eps, residual=residual)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    r2 = (None if residual is None
          else residual.reshape(-1, shape[-1]).contiguous())
    return kernel.rmsnorm_cuda(x2, w, eps=eps, residual=r2).reshape(shape)
