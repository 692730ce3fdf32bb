"""Fused channel-ring commit as a CUDA kernel for Hopper
(``csrc/channel_ring.cu``), bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/channel_ring/kernel.py``
(``_commit_kernel``, wrapper ``ring_commit_tpu``). One thread owns one
``(lane, sender, receiver, field)`` column of the ring: it clears slot
``t % D`` and merges the tick's sends into their target slots in entry
order, so no atomics are needed and the result is bitwise equal to the
plain version (ref.py). See the source for the design and its bound.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "channel_ring"
LAYOUT_COLS = 5   # off, w, flag_off, additive, value offset

launch_count = 0
_built: Optional[_build.Built] = None


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        fn = built.lib.channel_ring_commit
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = built.lib.channel_ring_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ring_commit_cuda(buf: torch.Tensor, t: int, fill: torch.Tensor,
                     slots: torch.Tensor, vals: torch.Tensor,
                     flags: torch.Tensor, table: torch.Tensor
                     ) -> torch.Tensor:
    """Commit one tick into ``buf`` in place on the current stream and
    return it. buf: [B, D, n, n, K] float32; fill: [K] float32;
    slots: [B, n, n, E] int32; vals: [B, n, n, W] float32; flags:
    [B, n, n, E] float32; table: [E, 5] int32 per-entry (off, w,
    flag_off, additive, value offset), as ops.layout_table builds it."""
    global launch_count
    if not buf.is_cuda:
        raise ValueError(f"the CUDA channel-ring kernel needs CUDA tensors, "
                         f"got buf on {buf.device}")
    if buf.dim() != 5:
        raise ValueError(f"buf must be [B, D, n, n, K], got {buf.shape}")
    B, D, n, n2, K = buf.shape
    if n2 != n:
        raise ValueError(f"buf must be [B, D, n, n, K], got {buf.shape}")
    E, W = slots.shape[-1], vals.shape[-1]
    dev = buf.device
    _check("buf", buf, torch.float32, buf.shape, dev)
    _check("fill", fill, torch.float32, (K,), dev)
    _check("slots", slots, torch.int32, (B, n, n, E), dev)
    _check("vals", vals, torch.float32, (B, n, n, W), dev)
    _check("flags", flags, torch.float32, (B, n, n, E), dev)
    _check("table", table, torch.int32, (E, LAYOUT_COLS), dev)
    if t < 0:
        raise ValueError(f"tick must be >= 0, got {t}")
    lib = build().lib
    err = lib.channel_ring_commit(
        buf.data_ptr(), fill.data_ptr(), slots.data_ptr(), vals.data_ptr(),
        flags.data_ptr(), table.data_ptr(), B, D, n, K, E, W, int(t),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("channel_ring_commit launch failed: "
                           + lib.channel_ring_error_string(err).decode())
    launch_count += 1
    return buf
