"""Fused (residual +) RMSNorm as a CUDA kernel for Hopper
(``csrc/rmsnorm.cu``), bound with ctypes.

Replaces the Pallas TPU kernels ``repro/kernels/rmsnorm/kernel.py``
(``_rmsnorm_kernel`` and ``_rmsnorm_res_kernel``, wrapper ``rmsnorm_2d``).
A row of ``[N, D]`` lives in registers, read once with 16-byte loads;
``plan`` picks the threads of a row and the vectors of a thread. See the
source for the design and its bound.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

NAME = "rmsnorm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132             # H100 SXM streaming multiprocessors
FILL_WARPS = 8        # warps an SM should hold for a warp a row to pay
MAX_THREADS = 256     # threads per row (csrc kMaxThreads)
MAX_VEC = 8           # vectors a thread keeps in registers (csrc kMaxVec)

launch_count = 0
_built: Optional[_build.Built] = None


class Plan(NamedTuple):
    """How the kernel lays a row over threads (one CTA a row)."""
    threads: int        # threads per row, a multiple of 32
    vec: int            # elements per vector
    per_thread: int     # vectors per thread
    in_registers: bool  # per_thread <= MAX_VEC: the row is read once


@functools.lru_cache(maxsize=256)
def plan(n: int, d: int, dtype: torch.dtype, vec_bytes: int = 16) -> Plan:
    """The launch plan for ``n`` rows of ``d`` elements of ``dtype``, with
    vectors of ``vec_bytes`` (16, or one element's size where the row or a
    pointer is not 16-byte aligned). One warp per row when there are rows
    enough to fill the card (FILL_WARPS on each of SMS SMs) and a warp's
    share fits in registers; else as many threads, up to MAX_THREADS, as
    the row has vectors. A row that needs more than MAX_VEC vectors a
    thread is looped over (read twice)."""
    vec = max(1, vec_bytes // dtype.itemsize)
    nvec = math.ceil(d / vec)
    if n >= SMS * FILL_WARPS and math.ceil(nvec / 32) <= MAX_VEC:
        threads = 32
    else:
        threads = min(MAX_THREADS, 32 * math.ceil(nvec / 32))
    per = math.ceil(nvec / threads)
    return Plan(threads, vec, per, per <= MAX_VEC)


def vector_bytes(d: int, *tensors: torch.Tensor) -> int:
    """16 when a row of ``d`` elements of the first tensor's type is a
    whole number of 16-byte vectors and every tensor's data is aligned for
    its vectors of that many elements; else the first tensor's element
    size (one element a load)."""
    size = tensors[0].element_size()
    vec = 16 // size
    if d % vec == 0 and all(
            t.data_ptr() % min(16, vec * t.element_size()) == 0
            for t in tensors):
        return 16
    return size


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        fn = built.lib.rmsnorm_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_int] * 6
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
    float32 or bfloat16 (read in its own type); residual: None or like x.
    Returns a new [N, D] tensor of x's dtype, launched on the current
    stream."""
    global launch_count
    if not x.is_cuda:
        raise ValueError(f"the CUDA RMSNorm kernel needs CUDA tensors, got "
                         f"x on {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype} and w {w.dtype}; the kernel "
                        f"takes {sorted(map(str, DTYPES))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, d = x.shape
    if tuple(w.shape) != (d,) or w.device != x.device:
        raise ValueError(f"w must be [{d}] on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    w = w.contiguous()
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous()):
            raise ValueError("residual must be a contiguous tensor of x's "
                             "shape, dtype and device")
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    vb = vector_bytes(d, *(t for t in (x, out, residual, w)
                           if t is not None))
    p = plan(n, d, x.dtype, vb)
    lib = build().lib
    dev = x.device
    err = lib.rmsnorm_launch(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        w.data_ptr(), out.data_ptr(), n, d, float(eps), DTYPES[x.dtype],
        DTYPES[w.dtype], int(vb == 16), p.threads, p.per_thread,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("rmsnorm launch failed: "
                           + lib.rmsnorm_error_string(err).decode())
    launch_count += 1
    return out
