"""Flash-decoding (one query token over a KV cache, GQA, ``kv_len``
masking) as a CUDA kernel for Hopper (``csrc/decode_attention.cu``),
bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``_decode_kernel``, wrapper ``decode_attention_pallas``). S is split over
CTAs, each CTA serves all ``H / Kh`` query heads of one KV head from one
read of each K/V tile, and a second small kernel combines the splits'
partial softmax sums; see the source for the design and its bound. The
split count is chosen here from S and the card alone, never from
``kv_len`` (reading it would synchronise with the device): CTAs past
``kv_len[b]`` return at once.

Two split kernels, chosen by dtype, both on the tensor cores with a
cp.async ring of K and V tiles: float32 goes to the 3xTF32 kernel
(``decode_tf32_kernel``, mma.sync m16n8k8), bfloat16 to the bf16 kernel
(``decode_bf16_kernel``, mma.sync m16n8k16). Both take ``stage()`` keys
a ring stage, and their split plan (``wave_plan``) cuts S into whole
stages and fills one wave of the CTAs that fit on the card at once, as the
CUDA occupancy calculator counts them for the kernel that runs
(``ctas_per_sm``). Both use the same combine kernel.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the calls of ``decode_attention_cuda`` that launched (each launches
the split kernel and the combine kernel); nothing else changes it.
``decode_attention_loads_cuda`` runs the float32 kernel's copies alone,
for measuring, and is not counted.
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

launch_count = 0
_built: Optional[_build.Built] = None
_per_sm: dict = {}        # (dtype, D, G, device index) -> ctas_per_sm


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        for fn in (built.lib.decode_attention_launch,
                   built.lib.decode_attention_loads_launch):
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                           + [ctypes.c_longlong] * 6 + [ctypes.c_float]
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        fn = built.lib.decode_ctas_per_sm
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        built.lib.decode_stage.argtypes = []
        built.lib.decode_stage.restype = ctypes.c_int
        fn = built.lib.decode_smem_bytes
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        err_str = built.lib.decode_attention_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def wave_plan(s: int, ctas: int, sms: int, per_sm: int,
              tile: int) -> tuple:
    """(splits, chunk): S cut into ``splits`` ranges of ``chunk`` keys, a
    multiple of ``tile`` and none of them empty, as many as fit in one wave
    of ``per_sm * sms`` CTAs when each split takes ``ctas`` CTAs (at least
    one split), since a wave that is partly empty leaves bandwidth unused
    for a kernel bound by bytes."""
    splits = min(max(1, (per_sm * sms) // max(ctas, 1)), math.ceil(s / tile))
    chunk = math.ceil(math.ceil(s / splits) / tile) * tile
    return math.ceil(s / chunk), chunk


def stage() -> int:
    """Keys a ring stage of both split kernels, as the library is built
    (the tile ``ref``'s twins need to follow the kernel's order). Needs
    the library, so a card."""
    return build().lib.decode_stage()


def ctas_per_sm(dtype: torch.dtype, d: int, g: int, index: int) -> int:
    """CTAs of the split kernel that serves ``dtype`` at head dim ``d`` and
    ``g`` query heads a KV head (float32 has one kernel for g <= 8 and one
    for more) that an SM of CUDA device ``index`` holds at once, from the
    occupancy calculator (its registers, shared memory and threads); asked
    once per key."""
    key = (dtype, d, g, index)
    if key not in _per_sm:
        n = ctypes.c_int(0)
        lib = build().lib
        err = lib.decode_ctas_per_sm(DTYPES[dtype], d, g, index,
                                     ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError(
                f"decode_attention occupancy ({dtype}, D={d}, G={g}): "
                + lib.decode_attention_error_string(err).decode()
                + f" ({n.value} CTAs per SM)")
        _per_sm[key] = n.value
    return _per_sm[key]


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of the split kernel for ``dtype`` at head dim
    ``d``, as the library is built (its ring of K and V stages). Needs the
    library, so a card."""
    return build().lib.decode_smem_bytes(DTYPES[dtype], d)


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def plan(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """(splits, chunk) of ``decode_attention_cuda`` for these CUDA tensors
    (q [B, H, D], k [B, Kh, S, D])."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_sm = ctas_per_sm(q.dtype, d, h // kh, _index(q.device))
    return wave_plan(max(s, 1), b * kh, sms, per_sm, stage())


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, H, D] and k, v [B, Kh, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kh = k.shape[1]
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
    # both kernels copy K and V rows 16 bytes at a time
    per16 = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride on its last dim")
        if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(f"{name} needs a 16-byte aligned start and "
                             f"strides that are multiples of {per16} "
                             f"elements ({q.dtype}), got {t.stride()}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


def _launch(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_len: torch.Tensor) -> torch.Tensor:
    _check(q, k, v, kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    dev = q.device
    lens = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    splits, chunk = plan(q, k)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((2, b, h, splits), dtype=torch.float32,
                          device=dev)
    lib = build().lib
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), b, h, kh, s, d, splits, chunk, k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(d),
        DTYPES[q.dtype], _index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: "
                           + lib.decode_attention_error_string(err).decode())
    return out


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D] contiguous; k, v: [B, Kh, S, D] with unit stride on D,
    a 16-byte aligned start and strides on B, Kh, S of whole 16 bytes; one
    dtype (float32 or bfloat16) on one CUDA device; kv_len: [B] integers
    (positions >= kv_len[b] are masked; a kv_len[b] of 0 gives NaN, as the
    plain version does). H % Kh == 0, H / Kh <= MAX_GROUP, D in HEAD_DIMS.
    Returns a new [B, H, D] tensor of q's dtype, launched on the current
    stream."""
    global launch_count
    out = _launch("decode_attention_launch", q, k, v, kv_len)
    if out.numel():
        launch_count += 1
    return out


def decode_attention_loads_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                kv_len: torch.Tensor) -> torch.Tensor:
    """For measuring only: the float32 kernel's copies, barriers and
    partials with no arithmetic (the memory path's share of its time), and
    the combine kernel, on the inputs of ``decode_attention_cuda`` at its
    split plan. Returns a finite [B, H, D] tensor that is not attention.
    Not counted."""
    if q.dtype != torch.float32:
        raise TypeError(f"the loads-only kernel is float32 only, got "
                        f"{q.dtype}")
    return _launch("decode_attention_loads_launch", q, k, v, kv_len)
