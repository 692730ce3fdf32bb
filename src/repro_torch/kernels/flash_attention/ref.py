"""Plain PyTorch version of the flash attention kernel, as the reference's
``attention_ref``: the scores materialised, softmax in fp32, GQA by head
grouping (query head h reads KV head ``h // (H / Kh)``). This is the CPU
path of ``ops.flash_attention`` and the yardstick the CUDA kernels are
held to.

``attention_kernel_order`` computes the same in the order the bf16
tensor-core kernel rounds (per key tile, P in bf16): the card's second,
tighter yardstick for that kernel, as ``ssm_scan_kernel_order`` is for the
scan. ``attention_tf32x3_order`` computes it in the float32 tensor-core
kernel's arithmetic: every product split into TF32 halves (3xTF32), each
product step rounded as the tensor cores round."""
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


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value nearest each finite float32 of ``x``, ties away from
    zero (as ``cvt.rna.tf32.f32`` rounds), with the 13 low mantissa bits
    cleared: half a TF32 ulp added to the bits, then masked, as the
    kernel's ``to_tf32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def round_to_f32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """float64 ``x`` to float32: to nearest ("rn") or toward zero ("rz")."""
    f = x.float()
    if rounding == "rn":
        return f
    if rounding != "rz":
        raise ValueError(f"rounding must be 'rn' or 'rz', got {rounding!r}")
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


# Bits below float32's 24 that the tensor cores keep of each term when
# they align a product step's terms to its largest: read on an H100, where
# this rule matches the float32 kernel's sums bit for bit
# (tools/tf32_accuracy.py)
TC_EXTRA_BITS = 2


def fused_step(t: torch.Tensor, prods: torch.Tensor, rounding: str = "rz",
               extra_bits: int | None = TC_EXTRA_BITS) -> torch.Tensor:
    """One m16n8k8 product step into the float32 accumulator ``t``: the
    products ``prods`` [..., n] (float64, exact, as TF32 products are) and
    t summed and rounded once to float32. "rz" as the tensor cores do it:
    every term cut toward zero to ``extra_bits`` bits below float32's
    precision at the largest term's leading bit, the sum (then exact) cut
    toward zero; ``extra_bits=None`` sums exactly first. "rn": the exact
    sum rounded to nearest."""
    terms = torch.cat([t.double()[..., None], prods], dim=-1)
    if rounding == "rz" and extra_bits is not None:
        _, e = torch.frexp(terms.abs().amax(dim=-1, keepdim=True))
        quantum = torch.ldexp(torch.ones_like(terms[..., :1]),
                              e - 24 - extra_bits)
        terms = torch.trunc(terms / quantum) * quantum
    return round_to_f32(terms.sum(dim=-1), rounding)


def mma_tf32x3(eq: str, a: torch.Tensor, a_dim: int, b: torch.Tensor,
               b_dim: int, c: torch.Tensor, passes: int,
               rounding: str) -> torch.Tensor:
    """c plus the einsum ``eq`` of a and b, which sums a's axis ``a_dim``
    against b's ``b_dim``, in 8-wide blocks of that axis as the kernel's
    m16n8k8 products run. Per block, from a zeroed float32 temporary t:
    t += a_lo b_hi, t += a_hi b_lo, t += a_hi b_hi (passes=3), or a_hi b_hi
    alone (passes=1), each a ``fused_step``; then c += t in float32."""
    ins, out = eq.split("->")
    each = f"{ins}->{out}{ins.split(',')[0][a_dim]}"    # keep the products
    ah, al = (t.double() for t in _split(a))
    bh, bl = (t.double() for t in _split(b))
    terms = ([(al, bh), (ah, bl)] if passes == 3 else []) + [(ah, bh)]
    for c0 in range(0, a.shape[a_dim], 8):
        n = min(8, a.shape[a_dim] - c0)
        t = torch.zeros_like(c)
        for x, y in terms:
            t = fused_step(t, torch.einsum(each, x.narrow(a_dim, c0, n),
                                           y.narrow(b_dim, c0, n)), rounding)
        c = c + t
    return c


def attention_tf32x3_order(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           block_k: int = 64, passes: int = 3,
                           rounding: str = "rz") -> torch.Tensor:
    """The float32 attention in the arithmetic of the 3xTF32 tensor-core
    kernel: S = Q K^T and O += P V with every operand split as hi =
    tf32(x), lo = tf32(x - hi), per 8-wide block of the summed axis as
    a_lo b_hi + a_hi b_lo + a_hi b_hi, each product step rounded once
    (``rounding``: "rz" as the tensor cores round, ``fused_step``, or "rn",
    to nearest) into a per-block temporary added to the sum in float32
    (``mma_tf32x3``); S from zero per key tile, O carried across tiles; an
    online softmax in base 2 over key tiles of ``block_k``; acc / max(l,
    1e-30).
    ``passes=1`` keeps a_hi b_hi alone: one TF32 pass, which the float32
    tolerance does not admit. Same shapes as ``attention_ref``; float32.
    What it does not model: the kernel's exponentials (ex2.approx, within
    2 ulp) and its order of summing l."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kh, h // kh, d)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, kh, h // kh, sq), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, h // kh, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kt = k[:, k0:k0 + block_k].float()
        vt = v[:, k0:k0 + block_k].float()
        s0 = torch.zeros((b, kh, h // kh, sq, kt.shape[1]), device=q.device)
        s = mma_tf32x3("bqkgd,btkd->bkgqt", qg, 4, kt, 3, s0, passes,
                       rounding) * scale_log2
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            s = s.masked_fill(cols[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row with no visible key yet keeps p = 0 and corr = 0
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = mma_tf32x3("bkgqt,btkd->bkgqd", p, 4, vt, 1,
                         acc * corr[..., None], passes, rounding)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
