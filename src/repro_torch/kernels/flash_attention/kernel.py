"""Flash attention (forward, causal or not, GQA) as a CUDA kernel for
Hopper (``csrc/flash_attention.cu``), bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_flash_kernel``, wrapper ``flash_attention_bhsd``). It reads and writes
the model layout ``[B, S, H, D]`` directly, so neither the reference's
transposes nor its padding of S to a block multiple are needed: ragged S
is bound-checked in the kernel. See the source for the design and its
bound.

Two kernels, chosen by dtype: float32 (and bfloat16 at D in {16, 32})
goes to the CUDA-core kernel; bfloat16 at D in ``TC_HEAD_DIMS``
goes to the tensor-core kernel (wgmma, TMA), launched with the plan of
``tc_plan``. Both count in ``launch_count``.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)     # bfloat16 head dims of the tensor-core kernel
TC_BLOCK_Q = 128             # query rows per CTA (two warpgroups of 64)
TC_BLOCK_K = 128             # keys per tile of the K/V ring
TC_STAGES = {64: 3, 128: 2}  # ring depth by head dim
SMEM_PER_BLOCK = 232448      # bytes a block may use on sm_90

launch_count = 0
_built: Optional[_build.Built] = None


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        fn = built.lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = built.lib.flash_attention_tc_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = built.lib.flash_attention_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


@dataclass(frozen=True)
class TcPlan:
    """The launch constants of the tensor-core kernel for one head dim; the
    source is built with the same ones and refuses any others."""
    block_q: int
    block_k: int
    stages: int
    smem_bytes: int      # dynamic shared memory: Q, the ring, alignment


def tc_plan(d: int) -> TcPlan:
    """The tile plan of the bf16 tensor-core kernel at head dim ``d``."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core kernel takes head_dim "
                         f"{TC_HEAD_DIMS}, got {d}")
    stages = TC_STAGES[d]
    tile = TC_BLOCK_K * d * 2
    smem = TC_BLOCK_Q * d * 2 + stages * 2 * tile + 1024
    return TcPlan(block_q=TC_BLOCK_Q, block_k=TC_BLOCK_K, stages=stages,
                  smem_bytes=smem)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, Kh, D]; one dtype (float32 or
    bfloat16), contiguous, on one CUDA device; H % Kh == 0; D in
    HEAD_DIMS. Returns a new [B, Sq, H, D] tensor of q's dtype, launched
    on the current stream."""
    global launch_count
    if not q.is_cuda:
        raise ValueError(f"the CUDA flash attention kernel needs CUDA "
                         f"tensors, got q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Sq, H, D] and k, v [B, Sk, Kh, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need H % Kh == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; the kernel is built "
                         f"for {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build().lib
    dev = q.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if q.dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 "tensor-core kernel's TMA copies")
        plan = tc_plan(d)
        err = lib.flash_attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kh, d, int(bool(causal)), 1.0 / math.sqrt(d),
            plan.block_q, plan.block_k, plan.stages, index, stream)
    else:
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kh, d, int(bool(causal)), 1.0 / math.sqrt(d),
            DTYPES[q.dtype], index, stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    launch_count += 1
    return out
