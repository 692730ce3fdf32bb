"""Flash-decoding (one query token over a KV cache, GQA, ``kv_len``
masking) as a CUDA kernel for Hopper (``csrc/decode_attention.cu``),
bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``_decode_kernel``, wrapper ``decode_attention_pallas``). S is split over
CTAs, each CTA serves all ``H / Kh`` query heads of one KV head from one
read of each K/V tile, and a second small kernel combines the splits'
partial softmax sums; see the source for the design and its bound. The
split count is chosen here from S and the card's SM count alone, never
from ``kv_len`` (reading it would synchronise with the device): CTAs past
``kv_len[b]`` return at once.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the calls of this wrapper that launched (each launches the split
kernel and the combine kernel); nothing else changes it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "decode_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16            # query heads per KV head (H / Kh)
TILE = 32                 # keys per tile in the kernel
CTAS_PER_SM = 4           # the split count aims at this many CTAs per SM

launch_count = 0
_built: Optional[_build.Built] = None


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        fn = built.lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = built.lib.decode_attention_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def split_plan(s: int, ctas: int, sms: int) -> tuple:
    """(splits, chunk): S cut into ``splits`` ranges of ``chunk`` keys, a
    multiple of the tile, so that ``ctas`` CTAs per split fill about
    CTAS_PER_SM per SM."""
    want = max(1, math.ceil(CTAS_PER_SM * sms / max(ctas, 1)))
    splits = min(want, math.ceil(s / TILE))
    chunk = math.ceil(math.ceil(s / splits) / TILE) * TILE
    return math.ceil(s / chunk), chunk


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D] contiguous; k, v: [B, Kh, S, D] with unit stride on D
    (any strides on B, Kh, S); one dtype (float32 or bfloat16) on one CUDA
    device; kv_len: [B] integers (positions >= kv_len[b] are masked; a
    kv_len[b] of 0 gives zeros). H % Kh == 0, H / Kh <= MAX_GROUP, D in
    HEAD_DIMS. Returns a new [B, H, D] tensor of q's dtype, launched on the
    current stream."""
    global launch_count
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, H, D] and k, v [B, Kh, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need H % Kh == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; the kernel is built "
                         f"for {HEAD_DIMS}")
    if h // kh > MAX_GROUP:
        raise ValueError(f"{h // kh} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be [{b}], got {tuple(kv_len.shape)}")
    if not q.is_cuda:
        raise ValueError(f"the CUDA decode attention kernel needs CUDA "
                         f"tensors, got q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride on its last dim")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    lens = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, chunk = split_plan(max(s, 1), b * kh, sms)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((2, b, h, splits), dtype=torch.float32,
                          device=dev)
    lib = build().lib
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), b, h, kh, s, d, splits, chunk,
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(d),
        DTYPES[q.dtype],
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    launch_count += 1
    return out
