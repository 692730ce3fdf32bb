"""Dispatch wrapper for flash attention.

Called from ``models/layers.attention_core`` under
``attention_impl="pallas"`` for full causal self-attention (the prefill
forward), once per layer. It takes the model layout ``[B, S, H, D]`` and
picks the backend by the rule of ``kernels/_dispatch.py`` (``"auto"``: the
CUDA kernel for CUDA tensors, the plain version for CPU tensors; no
fallback).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dispatch
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, backend: str = "auto"
                    ) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, Kh, D] (model layout). Returns q's
    layout."""
    if _dispatch.resolve_backend(backend, q.device, "flash attention") \
            == "ref":
        return attention_ref(q, k, v, causal=causal)
    return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)
