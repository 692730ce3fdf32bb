"""Dispatch wrapper for flash-decoding.

The entry point of the kernel, as the reference's
``kernels/decode_attention/ops.py::decode_attention`` is: no model path
calls it (the models decode through ``layers.chunked_attention`` with a
``kv_len``, the reference's route). It picks the backend by the rule of
``kernels/_dispatch.py`` (``"auto"``: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors; no fallback). On the card float32
runs ``decode_tf32_kernel`` (3xTF32) and bfloat16 ``decode_bf16_kernel``,
both on the tensor cores (kernel.py). The reference's ``bs`` knob has no
counterpart: the kernels take any S.

k and v may be views with any strides over their first three dims, so the
model's cache ``[B, S, Kh, D]`` is passed as ``cache.transpose(1, 2)``
without a copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dispatch
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     backend: str = "auto") -> torch.Tensor:
    """q: [B, H, D]; k, v: [B, Kh, S, D]; kv_len: [B] -> [B, H, D]."""
    if _dispatch.resolve_backend(backend, q.device,
                                 "decode attention") == "ref":
        return decode_attention_ref(q, k, v, kv_len)
    return kernel.decode_attention_cuda(q.contiguous(), k, v, kv_len)
