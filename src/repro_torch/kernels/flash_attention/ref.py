"""Plain PyTorch version of the flash attention kernel, as the reference's
``attention_ref``: the scores materialised, softmax in fp32, GQA by head
grouping (query head h reads KV head ``h // (H / Kh)``). This is the CPU
path of ``ops.flash_attention`` and the yardstick the CUDA kernels are
held to.

``attention_kernel_order`` computes the same in the order the bf16
tensor-core kernel rounds (per key tile, P in bf16): the card's second,
tighter yardstick for that kernel, as ``ssm_scan_kernel_order`` is for the
scan."""
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


def attention_kernel_order(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           block_k: int = 128) -> torch.Tensor:
    """The same attention in the rounding order of the bf16 tensor-core
    kernel: float32 scores from the inputs, an online softmax over key
    tiles of ``block_k`` (running max m, sum l of the float32
    probabilities), the probabilities rounded to v's dtype before P V,
    float32 accumulation, one cast of acc / max(l, 1e-30) at the end. In
    float32 the rounding of P is none and this is ``attention_ref`` up to
    the order of the sums. Same shapes and result as ``attention_ref``."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kh, h // kh, d)
    scale = 1.0 / math.sqrt(d)
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, kh, h // kh, sq), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, h // kh, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kt = k[:, k0:k0 + block_k].float()
        vt = v[:, k0:k0 + block_k]
        s = torch.einsum("bqkgd,btkd->bkgqt", qg, kt) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            s = s.masked_fill(cols[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row with no visible key yet keeps p = 0 and corr = 0
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(s - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(v.dtype).float(), vt.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
