"""Plain PyTorch version of the flash-decoding kernel, as the reference's
``decode_attention_ref``: one query token against a (possibly partially
filled) KV cache, the scores materialised, softmax in fp32, GQA by head
grouping. This is the CPU path of ``ops.decode_attention`` and the
yardstick the CUDA kernel is held to.

With ``kv_len[b] = 0`` every score is masked and the softmax gives NaN, as
the reference's oracle does (the reference's Pallas kernel gives the mean
of V there, the port's kernel zeros; ROADMAP Queue C).
"""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k, v: [B, Kh, S, D] (any strides); kv_len: [B] —
    positions >= kv_len are masked. Returns [B, H, D] in v's dtype."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    logits = torch.einsum("bkgd,bktd->bkgt", qg, k).float()
    logits = logits / math.sqrt(d)
    kv_len = kv_len.to(q.device).reshape(b)
    valid = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p.to(v.dtype), v)
    return out.reshape(b, h, d)
