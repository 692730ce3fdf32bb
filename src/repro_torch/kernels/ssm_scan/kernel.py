"""The Mamba selective scan as a CUDA kernel for Hopper
(``csrc/ssm_scan.cu``), bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan/kernel.py``
(``_ssm_kernel``, wrapper ``ssm_scan_pallas``). Two threads own one
(batch, channel) and carry its ``[N]`` fp32 state in registers along S,
half each, its x, dt, B and C staged through a ring of shared memory by
cp.async; see the source for the design and its bound. Unlike the reference it
needs no block to divide Di or S: any S and Di are taken.

``ssm_scan_loads_cuda`` launches the same kernel's copies in and out
alone, for measuring the memory path's share of the time
(``chip_smoke.py`` phase 11); it is on no model path and not counted.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches ``ssm_scan_cuda`` made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "ssm_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (2, 4, 8, 16)   # the d_state values the repo's configs use

launch_count = 0
_built: Optional[_build.Built] = None


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        for fn in (built.lib.ssm_scan_launch, built.lib.ssm_scan_loads_launch):
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        err_str = built.lib.ssm_scan_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def _launch(entry: str, x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, A: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Check the inputs and launch the library's ``entry`` on them."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be one [Bt, S, Di] shape, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    bsz, s, di = x.shape
    n = A.shape[-1]
    if (A.dim() != 2 or A.shape[0] != di or B.shape != (bsz, s, n)
            or C.shape != B.shape or tuple(D.shape) != (di,)):
        raise ValueError(f"B, C must be [{bsz}, {s}, N], A [{di}, N] and D "
                         f"[{di}], got {tuple(B.shape)}, {tuple(C.shape)}, "
                         f"{tuple(A.shape)}, {tuple(D.shape)}")
    if n not in STATE_SIZES:
        raise ValueError(f"state size N={n} not supported; the kernel is "
                         f"built for {STATE_SIZES}")
    if not x.is_cuda:
        raise ValueError(f"the CUDA ssm_scan kernel needs CUDA tensors, got "
                         f"x on {x.device}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"x, dt, B, C must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {x.dtype}, "
                        f"{dt.dtype}, {B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("B", B), ("C", C), ("A", A), ("D", D)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    A = A.float().contiguous()
    D = D.float().contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = build().lib
    dev = x.device
    err = getattr(lib, entry)(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), out.data_ptr(), bsz, s, di, n,
        DTYPES[x.dtype],
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.ssm_scan_error_string(err).decode())
    return out


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, A: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """x, dt: [Bt, S, Di]; B, C: [Bt, S, N], all four of one dtype (float32
    or bfloat16), contiguous, on one CUDA device; A: [Di, N] and D: [Di]
    (read as float32); N in STATE_SIZES. Returns a new [Bt, S, Di] tensor
    of x's dtype, launched on the current stream."""
    global launch_count
    out = _launch("ssm_scan_launch", x, dt, B, C, A, D)
    launch_count += 1
    return out


def ssm_scan_loads_cuda(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, A: torch.Tensor,
                        D: torch.Tensor) -> torch.Tensor:
    """For measuring only: the scan kernel's copies alone on the inputs of
    ``ssm_scan_cuda``, returning y = x + dt + B[..., :1] + C[..., :1]
    (float32 sums, one cast to x's dtype) in place of the scan. Not
    counted."""
    return _launch("ssm_scan_loads_launch", x, dt, B, C, A, D)
