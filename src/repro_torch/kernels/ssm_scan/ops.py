"""Dispatch wrapper for the selective scan.

Called from ``models/ssm.mamba_ssm`` when ``use_kernel`` (the reference's
``ssm.py:76-78``), once per ``mamba_forward``. It picks the backend by the
rule of ``kernels/_dispatch.py`` (``"auto"``: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors; no fallback). The plain
version ends in the kernel's order (``ref.ssm_scan_kernel_order``: D*x
added in fp32, one cast to x.dtype), so the result's dtype and rounding
do not depend on the device. The reference's ``bd`` and ``chunk`` knobs
have no counterpart: the kernel takes any S and Di as they are.
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
    if _dispatch.resolve_backend(backend, x.device, "ssm_scan") == "ref":
        return ssm_scan_kernel_order(x, dt, B, C, A, D)
    return kernel.ssm_scan_cuda(x.contiguous(), dt.contiguous(),
                                B.contiguous(), C.contiguous(), A, D)
