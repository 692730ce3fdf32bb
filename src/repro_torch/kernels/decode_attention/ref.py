"""Plain PyTorch version of the flash-decoding kernel, as the reference's
``decode_attention_ref``: one query token against a (possibly partially
filled) KV cache, the scores materialised, softmax in fp32, GQA by head
grouping. This is the CPU path of ``ops.decode_attention`` and the
yardstick the CUDA kernels are held to.

Two twins compute the same in a kernel's own order, the card's second,
tighter yardstick for it, on the same cut of the keys (splits of the
kernel's plan, ring stages, the four warps' slices of each stage):
``decode_attention_kernel_order`` in the bf16 tensor-core kernel's (P
rounded to bf16 per stage), ``decode_attention_tf32x3_order`` in the
float32 kernel's 3xTF32 arithmetic (``flash_attention.ref.mma_tf32x3``).

With ``kv_len[b] = 0`` every score is masked and the softmax gives NaN, as
the reference's oracle does; the port's kernels and both twins give NaN
there too (the reference's Pallas kernel gives the mean of V).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import mma_tf32x3

NEG = float("-inf")


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


def _cut(q, k, v, kv_len, chunk, tile, warps):
    """The keys as a kernel reads them: S cut into splits of ``chunk`` keys
    (one split if None), each into ring stages of ``tile`` keys, each stage
    into ``warps`` slices of tile / warps keys. Returns (kt, vt, valid):
    K and V in float32 as [B, Kh, splits, stages, warps, per, D] and
    whether each key counts (inside its split, below S and kv_len[b]),
    [B, splits, stages, warps, per]."""
    b = q.shape[0]
    s = k.shape[2]
    chunk = s if chunk is None else chunk
    per = tile // warps
    n_tiles = math.ceil(chunk / tile)
    splits = math.ceil(s / chunk)
    off = torch.arange(n_tiles * tile, device=q.device)
    pos = (torch.arange(splits, device=q.device)[:, None] * chunk
           + off).reshape(splits, n_tiles, warps, per)
    lens = torch.clamp(kv_len.to(q.device).long(), max=s)
    valid = ((off < chunk).reshape(n_tiles, warps, per)
             & (pos[None] < lens.reshape(b, 1, 1, 1, 1)))
    idx = torch.clamp(pos, max=s - 1)
    return k.float()[:, :, idx], v.float()[:, :, idx], valid


def _combine(m, l, acc, dim, exp):
    """(m, l, acc) of several partial softmax sums along ``dim`` rescaled
    to their common max with ``exp`` and added; a part with no valid key
    (m = -inf) weighs 0."""
    mm = m.amax(dim=dim, keepdim=True)
    w = torch.where(mm == NEG, 0.0, exp(m - mm))
    return (mm.squeeze(dim), (l * w).sum(dim=dim),
            (acc * w[..., None]).sum(dim=dim))


def _finish(m, l, acc, q):
    """acc / max(l, 1e-30) as [B, H, D] in q's dtype; NaN where no key
    counted."""
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((m == NEG)[..., None], float("nan"), out)
    return out.reshape(q.shape).to(q.dtype)


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
    if s == 0:
        return torch.full_like(q, float("nan"))
    warps = 4
    kt, vt, valid = _cut(q, k, v, kv_len, chunk, tile, warps)
    qg = q.float().reshape(b, kh, h // kh, d)
    scale = 1.0 / math.sqrt(d)
    shape = (b, kh, h // kh, kt.shape[2], warps)
    m = torch.full(shape, NEG, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(shape + (d,), device=q.device)
    for t in range(kt.shape[3]):
        sc = torch.einsum("bkgd,bkswpd->bkgswp", qg, kt[:, :, :, t]) * scale
        sc = sc.masked_fill(~valid[:, None, None, :, t], NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_use = torch.where(m_new == NEG, 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(sc - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgswp,bkswpd->bkgswd", p.to(v.dtype).float(), vt[:, :, :, t])
        m = m_new
    m, l, acc = _combine(m, l, acc, 4, torch.exp)      # the warps of a CTA
    m, l, acc = _combine(m, l, acc, 3, torch.exp)      # the splits
    return _finish(m, l, acc, q)


def decode_attention_tf32x3_order(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kv_len: torch.Tensor, *,
                                  chunk: int | None = None, tile: int = 64,
                                  warps: int = 4, passes: int = 3,
                                  rounding: str = "rz") -> torch.Tensor:
    """The float32 attention in the arithmetic of the 3xTF32 tensor-core
    kernel (``decode_tf32_kernel``), on the keys cut as the kernel cuts
    them: splits of ``chunk`` keys (the kernel's plan; one split if None),
    ring stages of ``tile`` keys, ``warps`` slices of each stage. Every
    (split, slice) keeps its own online softmax over the stages in base 2:
    S^T = K Q^T from zero per stage and O^T += V^T P^T carried across
    them, as the kernel runs them (K and V the A operands), each through
    ``mma_tf32x3`` (operands split as hi = tf32(x), lo = tf32(x - hi), per
    8-wide block of the summed axis a_lo b_hi + a_hi b_lo + a_hi b_hi,
    each product step rounded as ``rounding`` says, "rz" as the tensor
    cores round, into a zeroed temporary added to S or O in float32); the
    scores scaled by log2(e) / sqrt(D) after the product. The
    slices are combined in base 2 and their max written in natural units,
    as the kernel's CTA does, the splits as its combine kernel does (exp),
    and acc / max(l, 1e-30). ``passes=1`` keeps a_hi b_hi alone: one TF32
    pass, which the float32 tolerance does not admit. Positions >= kv_len[b]
    are masked; a row with no valid key gives NaN, as the kernel does. Same
    shapes as ``decode_attention_ref``; float32. What it does not model:
    the kernel's exponentials (ex2.approx, within 2 ulp) and its order of
    summing l."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if s == 0:
        return torch.full_like(q, float("nan"))
    kt, vt, valid = _cut(q, k, v, kv_len, chunk, tile, warps)
    qg = q.float().reshape(b, kh, h // kh, d)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    shape = (b, kh, h // kh, kt.shape[2], warps)
    m = torch.full(shape, NEG, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(shape + (d,), device=q.device)
    for t in range(kt.shape[3]):
        s0 = torch.zeros(shape + (kt.shape[5],), device=q.device)
        sc = mma_tf32x3("bkswpd,bkgd->bkgswp", kt[:, :, :, t], 5, qg, 3, s0,
                        passes, rounding) * scale_log2
        sc = sc.masked_fill(~valid[:, None, None, :, t], NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # a slice with no valid key yet keeps p = 0 and corr = 0
        m_use = torch.where(m_new == NEG, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(sc - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = mma_tf32x3("bkswpd,bkgswp->bkgswd", vt[:, :, :, t], 4, p, 5,
                         acc * corr[..., None], passes, rounding)
        m = m_new
    m, l, acc = _combine(m, l, acc, 4, torch.exp2)     # the warps of a CTA
    m = m * math.log(2.0)                              # natural units
    m, l, acc = _combine(m, l, acc, 3, torch.exp)      # the splits
    return _finish(m, l, acc, q)
