"""Plain PyTorch version of the flash attention kernel, as the reference's
``attention_ref``: the scores materialised, softmax in fp32, GQA by head
grouping (query head h reads KV head ``h // (H / Kh)``). This is the CPU
path of ``ops.flash_attention`` and the yardstick the CUDA kernel is held
to."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, Kh, D]; H % Kh == 0. Returns
    [B, Sq, H, D] in v's dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float()
    logits = logits / math.sqrt(d)
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, d)
