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

Two split kernels, chosen by dtype: float32 goes to the CUDA-core kernel
(32-key tiles); bfloat16 to the tensor-core kernel (mma.sync,
a cp.async ring of 64-key tiles), whose split plan (``bf16_plan``) fills
one wave of the CTAs that fit on the card at once, as the CUDA occupancy
calculator counts them (``bf16_ctas_per_sm``). Both use the same combine
kernel.

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
TILE = 32                 # keys per tile in the float32 kernel
CTAS_PER_SM = 4           # the split count aims at this many CTAs per SM
BF16_TILE = 64            # keys per ring stage in the bfloat16 kernel

launch_count = 0
_built: Optional[_build.Built] = None
_per_sm: dict = {}        # (device index, D) -> bf16_ctas_per_sm


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
        fn = built.lib.decode_bf16_ctas_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        err_str = built.lib.decode_attention_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def _cut(s: int, splits: int, tile: int) -> tuple:
    """(splits, chunk): S cut into at most ``splits`` ranges of ``chunk``
    keys, a multiple of ``tile``, none of them empty."""
    splits = min(splits, math.ceil(s / tile))
    chunk = math.ceil(math.ceil(s / splits) / tile) * tile
    return math.ceil(s / chunk), chunk


def split_plan(s: int, ctas: int, sms: int) -> tuple:
    """(splits, chunk) of the float32 kernel: S cut into ``splits`` ranges
    of ``chunk`` keys, a multiple of the tile, so that ``ctas`` CTAs per
    split fill about CTAS_PER_SM per SM."""
    return _cut(s, max(1, math.ceil(CTAS_PER_SM * sms / max(ctas, 1))),
                TILE)


def bf16_plan(s: int, ctas: int, sms: int, per_sm: int) -> tuple:
    """(splits, chunk) of the bfloat16 kernel: 64-key tiles, and as many
    splits as fit in one wave of ``per_sm * sms`` CTAs (at least one),
    since a wave that is partly empty leaves bandwidth unused for a
    kernel bound by bytes."""
    return _cut(s, max(1, (per_sm * sms) // max(ctas, 1)), BF16_TILE)


def bf16_ctas_per_sm(d: int, index: int) -> int:
    """bfloat16 CTAs at head dim ``d`` that an SM of CUDA device ``index``
    holds at once, from the occupancy calculator (its registers, shared
    memory and threads); asked once per device and head dim."""
    if (index, d) not in _per_sm:
        n = ctypes.c_int(0)
        lib = build().lib
        err = lib.decode_bf16_ctas_per_sm(d, index, ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError(
                f"decode_attention occupancy at D={d}: "
                + lib.decode_attention_error_string(err).decode()
                + f" ({n.value} CTAs per SM)")
        _per_sm[(index, d)] = n.value
    return _per_sm[(index, d)]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D] contiguous; k, v: [B, Kh, S, D] with unit stride on D
    (any strides on B, Kh, S); one dtype (float32 or bfloat16) on one CUDA
    device; kv_len: [B] integers (positions >= kv_len[b] are masked; a
    kv_len[b] of 0 gives NaN, as the plain version does). H % Kh == 0,
    H / Kh <= MAX_GROUP, D in HEAD_DIMS. Returns a new [B, H, D] tensor of
    q's dtype, launched on the current stream."""
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
    if q.dtype == torch.bfloat16:
        # the bf16 kernel copies K and V rows 16 bytes at a time
        for name, t in (("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"bfloat16 {name} needs a 16-byte aligned "
                                 f"start and strides that are multiples of "
                                 f"8 elements, got {t.stride()}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lens = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if q.dtype == torch.bfloat16:
        splits, chunk = bf16_plan(max(s, 1), b * kh, sms,
                                  bf16_ctas_per_sm(d, index))
    else:
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
        DTYPES[q.dtype], index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("decode_attention launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    launch_count += 1
    return out
