"""The sketch's rank-bucket sums as a CUDA kernel for Hopper
(``csrc/sketch_buckets.cu``), bound with ctypes.

No Pallas kernel stands behind it: the reference sums its buckets with
jnp scatter-adds (``repro/distributed/sketch.py`` ``_bucketize``), which
XLA's CPU backend runs in index order, and ``index_add_`` on the card adds
by atomics in no fixed order. The kernel adds each bucket's run of the
sorted row in index order, a warp a bucket, so that the card's sketch is
the CPU's and the reference's bit for bit. See the source for the design
and its bound.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "sketch_buckets"
MAX_GRID = 65535      # lanes and bins each index a grid dimension

launch_count = 0
_built: Optional[_build.Built] = None


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        fn = built.lib.sketch_bucket_sums_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = built.lib.sketch_bucket_sums_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def bucket_sums_cuda(b: torch.Tensor, w: torch.Tensor, wv: torch.Tensor,
                     bins: int):
    """b: [L, M] int32 (or another integer type, converted), each row
    non-decreasing in [0, bins); w, wv: [L, M] float32; all on one CUDA
    device. Returns new (wsum, vsum) [L, bins] float32, launched on the
    current stream."""
    global launch_count
    if not b.is_cuda:
        raise ValueError(f"the CUDA sketch kernel needs CUDA tensors, got b "
                         f"on {b.device}")
    if b.dim() != 2:
        raise ValueError(f"b must be [L, M], got {tuple(b.shape)}")
    lanes, m = b.shape
    for name, x in (("w", w), ("wv", wv)):
        if x.shape != b.shape or x.dtype != torch.float32 \
                or x.device != b.device:
            raise ValueError(f"{name} must be float32 [L, M] = "
                             f"{tuple(b.shape)} on {b.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 1 <= bins <= MAX_GRID or lanes > MAX_GRID:
        raise ValueError(f"bins {bins} and lanes {lanes} must lie in "
                         f"[1, {MAX_GRID}]")
    b = b.to(torch.int32).contiguous()
    w, wv = w.contiguous(), wv.contiguous()
    wsum = torch.empty((lanes, bins), dtype=torch.float32, device=b.device)
    vsum = torch.empty_like(wsum)
    if lanes == 0:
        return wsum, vsum
    lib = build().lib
    dev = b.device
    err = lib.sketch_bucket_sums_launch(
        b.data_ptr(), w.data_ptr(), wv.data_ptr(), wsum.data_ptr(),
        vsum.data_ptr(), lanes, m, bins,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("sketch_bucket_sums launch failed: "
                           + lib.sketch_bucket_sums_error_string(err)
                           .decode())
    launch_count += 1
    return wsum, vsum
