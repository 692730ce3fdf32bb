"""Plain PyTorch version of the flash-decoding kernel, as the reference's
``decode_attention_ref``: one query token against a (possibly partially
filled) KV cache, the scores materialised, softmax in fp32, GQA by head
grouping. This is the CPU path of ``ops.decode_attention`` and the
yardstick the CUDA kernels are held to. ``decode_attention_kernel_order``
computes the same in the order the bf16 tensor-core kernel rounds (per
split, warp slice and tile, P in bf16): the card's second, tighter
yardstick for that kernel.

With ``kv_len[b] = 0`` every score is masked and the softmax gives NaN, as
the reference's oracle does; the port's kernels and
``decode_attention_kernel_order`` give NaN there too (the reference's
Pallas kernel gives the mean of V).
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


def decode_attention_kernel_order(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kv_len: torch.Tensor, *,
                                  chunk: int | None = None,
                                  tile: int = 64) -> torch.Tensor:
    """The same attention in the rounding order of the bf16 tensor-core
    kernel. S is cut into splits of ``chunk`` keys (the kernel's plan; one
    split if None), each split into tiles of ``tile`` keys, each tile into
    the kernel's four warps' slices of tile / 4 keys. Every (split, slice)
    keeps its own online softmax over the tiles in order: float32 scores,
    running max m and sum l of the float32 probabilities, the
    probabilities rounded to v's dtype before P V, float32 accumulation.
    The slices are combined as the kernel's CTA combines its warps, the
    splits as its combine kernel does, and acc / max(l, 1e-30) is cast
    once. Positions >= kv_len[b] are masked; a row with no valid key
    (kv_len[b] = 0, or S = 0) gives NaN, as the kernel does. In float32
    the rounding of P is none and this is ``decode_attention_ref`` up to
    the order of the sums (for kv_len >= 1)."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    if s == 0:
        return torch.full_like(q, float("nan"))
    chunk = s if chunk is None else chunk
    warps = 4
    per = tile // warps
    n_tiles = math.ceil(chunk / tile)
    splits = math.ceil(s / chunk)
    neg = float("-inf")
    # the key each (split, tile, warp, lane-slot) reads, and whether it
    # counts: inside its split's chunk, below S and below kv_len[b]
    off = torch.arange(n_tiles * tile, device=q.device)
    pos = (torch.arange(splits, device=q.device)[:, None] * chunk
           + off).reshape(splits, n_tiles, warps, per)
    lens = torch.clamp(kv_len.to(q.device).long(), max=s)
    valid = ((off < chunk).reshape(n_tiles, warps, per)
             & (pos[None] < lens.reshape(b, 1, 1, 1, 1)))
    idx = torch.clamp(pos, max=s - 1)
    kt = k.float()[:, :, idx]          # [B, Kh, splits, n_tiles, warps, per, D]
    vt = v.float()[:, :, idx]
    qg = q.float().reshape(b, kh, g, d)
    scale = 1.0 / math.sqrt(d)
    shape = (b, kh, g, splits, warps)
    m = torch.full(shape, neg, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(shape + (d,), device=q.device)
    for t in range(n_tiles):
        sc = torch.einsum("bkgd,bkswpd->bkgswp", qg, kt[:, :, :, t]) * scale
        sc = sc.masked_fill(~valid[:, None, None, :, t], neg)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_use = torch.where(m_new == neg, 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(sc - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgswp,bkswpd->bkgswd", p.to(v.dtype).float(), vt[:, :, :, t])
        m = m_new

    def combine(m, l, acc, dim):
        mm = m.amax(dim=dim, keepdim=True)
        w = torch.where(mm == neg, 0.0, torch.exp(m - mm))
        return (mm.squeeze(dim), (l * w).sum(dim=dim),
                (acc * w[..., None]).sum(dim=dim))

    m, l, acc = combine(m, l, acc, 4)          # the warps of a CTA
    m, l, acc = combine(m, l, acc, 3)          # the splits
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((m == neg)[..., None], float("nan"), out)
    return out.reshape(b, h, d).to(q.dtype)
