"""Dispatch wrapper for flash attention.

Called from ``models/layers.attention_core`` under
``attention_impl="pallas"`` for full causal self-attention (the prefill
forward), once per layer. It takes the model layout ``[B, S, H, D]`` and
picks the backend by the rule of ``kernels/_dispatch.py`` (``"auto"``: the
CUDA kernel for CUDA tensors, the plain version for CPU tensors; no
fallback). DTensor inputs run on each device's batch rows or heads
(``placements``) through ``local_map``.
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
    if _dispatch.is_dtensor(q):
        pl = placements(q, k)

        def local(q, k, v):
            return flash_attention(q, k, v, causal=causal, backend=backend)

        return _dispatch.local_call(local, (q, k, v), (pl, pl, pl), pl)
    if _dispatch.resolve_backend(backend, q.device, "flash attention") \
            == "ref":
        return attention_ref(q, k, v, causal=causal)
    return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)


def placements(q, k) -> tuple:
    """Where DTensors q [B, S, H, D] and k [B, S, Kh, D] can be attended
    locally: mesh dim by mesh dim, the batch (dim 0) or the heads (dim 2)
    sharded as q, else as k, has them; S whole. A shard of S, a pending
    sum, or heads that do not split evenly for both q and k (GQA pairs
    query head h with KV head h // G) are gathered first. q, k and v
    then share these placements."""
    from torch.distributed.tensor import Replicate, Shard
    choice = []
    for pq, pk in zip(q.placements, k.placements):
        dims = [_dispatch.shard_dim(pq), _dispatch.shard_dim(pk)]
        d = next((d for d in dims if d in (0, 2)), None)
        choice.append(Replicate() if d is None else Shard(d))
    choice = _dispatch.even_shards(q, choice)
    return tuple(_dispatch.even_shards(k, choice))
