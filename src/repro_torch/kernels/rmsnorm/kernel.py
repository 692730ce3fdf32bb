"""Fused (residual +) RMSNorm as a CUDA kernel for Hopper
(``csrc/rmsnorm.cu``), bound with ctypes.

Replaces the Pallas TPU kernels ``repro/kernels/rmsnorm/kernel.py``
(``_rmsnorm_kernel`` and ``_rmsnorm_res_kernel``, wrapper ``rmsnorm_2d``).
One warp normalises one row of ``[N, D]``; see the source for the design
and its bound.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "rmsnorm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
_built: Optional[_build.Built] = None


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        fn = built.lib.rmsnorm_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = built.lib.rmsnorm_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [N, D] float32 or bfloat16, contiguous, on a CUDA device; w: [D]
    (read as float32); residual: None or like x. Returns a new [N, D]
    tensor of x's dtype, launched on the current stream."""
    global launch_count
    if not x.is_cuda:
        raise ValueError(f"the CUDA RMSNorm kernel needs CUDA tensors, got "
                         f"x on {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPES))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, d = x.shape
    if tuple(w.shape) != (d,) or w.device != x.device:
        raise ValueError(f"w must be [{d}] on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    w = w.float().contiguous()
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous()):
            raise ValueError("residual must be a contiguous tensor of x's "
                             "shape, dtype and device")
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = build().lib
    dev = x.device
    err = lib.rmsnorm_launch(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        w.data_ptr(), out.data_ptr(), n, d, float(eps), DTYPES[x.dtype],
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("rmsnorm launch failed: "
                           + lib.rmsnorm_error_string(err).decode())
    launch_count += 1
    return out
