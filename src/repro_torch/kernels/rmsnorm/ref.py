"""Plain PyTorch version of the fused (residual-add +) RMSNorm kernel, as
the reference's ``rmsnorm_ref``: the residual add, the statistics and the
multiply by ``w`` in fp32, the output in ``x.dtype``. This is the CPU path
of ``ops.rmsnorm`` and the yardstick the CUDA kernel is held to."""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., D], w: [D]; residual, when given, has x's shape."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
