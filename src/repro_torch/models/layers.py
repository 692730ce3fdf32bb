"""Core layers of the decoder LM: RMSNorm, RoPE, GQA attention (dense,
chunked online-softmax, flash kernel; self and cross), SwiGLU MLP.
Plain PyTorch; the hand-written kernels are selected through
``CallConfig``, as the reference (``repro.models.layers``) selects its
Pallas kernels:

  ``use_pallas_norm``           -> ``kernels/rmsnorm`` (every ``rms_norm``);
  ``attention_impl="pallas"``   -> ``kernels/flash_attention`` for full
                                   causal self-attention (the prefill);
                                   every other attention (decode with its
                                   KV cache, cross-attention) takes the
                                   chunked path.

``CallConfig.kernel_backend`` picks the kernels' backend ("auto": the CUDA
kernel for CUDA tensors, the plain version for CPU tensors; "ref"; "cuda").
The kernels have no backward: under autograd both routes raise
(``refuse_grad``) on every device, as the reference's ``jax.grad`` through
a ``pallas_call`` does. Training takes "dense" or "chunked"; the latter's
``flash_chunked`` has the reference's custom backward.

Weights keep the reference's layout ([d_in, d_out], applied as ``x @ w``).
As in the reference, activations and weights share one dtype.

Under a mesh (``distributed/sharding.py``) parameters, batch and caches are
DTensors and every layer runs on them as it stands: a tensor a layer builds
for itself (RoPE's tables) is replicated onto the activations' mesh
(``replicated``), ``constrain_act`` redistributes the activations as the
reference's sharding constraint places them, and attention runs on each
device's batch rows or heads through ``local_map`` (its kernel never sees a
DTensor).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

ATTENTION_IMPLS = ("dense", "chunked", "pallas")


@dataclass(frozen=True)
class CallConfig:
    """How to execute the model (orthogonal to what the model is)."""
    compute_dtype: torch.dtype = torch.bfloat16
    # "dense" materializes [S, S] scores, "chunked" streams KV blocks with
    # an online softmax, "pallas" sends full causal self-attention to the
    # flash kernel (the rest as "chunked")
    attention_impl: str = "dense"
    attn_chunk: int = 512
    use_pallas_norm: bool = False
    # recompute each layer in the backward pass (torch.utils.checkpoint);
    # only matters when autograd records the forward
    remat: bool = True
    # expand KV to full heads before attention
    gqa_expand_kv: bool = False
    # backend of the hand-written kernels: "auto" | "ref" | "cuda"
    kernel_backend: str = "auto"
    # ---- sharding knobs (``constrain_act``; DTensor activations only) ----
    # constrain activations [B, S, D] to (batch_axes, seq_axis, None)
    batch_axes: Tuple[str, ...] = ()
    seq_axis: Optional[str] = None          # sequence parallelism
    # MoE expert-parallel axis for the dispatch all-to-alls (models/moe.py)
    moe_ep_axis: Optional[str] = None
    # tokens a MoE layer routes together (models/moe.py)
    moe_group_size: int = 1024

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}; one of "
                             f"{ATTENTION_IMPLS}")


def constrain_act(x: torch.Tensor, call: CallConfig) -> torch.Tensor:
    """The policy's activation sharding: a DTensor ``x`` is redistributed
    to (``batch_axes``, ``seq_axis`` where x has 3+ dims, None, ...) on its
    own mesh. A plain tensor is returned as it is, as the reference's
    constraint is a no-op without a mesh."""
    if (not call.batch_axes and call.seq_axis is None) \
            or not _dispatch.is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import placements
    spec: list = [None] * x.dim()
    if call.batch_axes:
        spec[0] = tuple(call.batch_axes)
    if call.seq_axis is not None and x.dim() >= 3:
        spec[1] = call.seq_axis
    return x.redistribute(x.device_mesh, placements(tuple(spec),
                                                   x.device_mesh))


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, built by a layer for itself, on ``like``'s mesh (replicated)
    when ``like`` is a DTensor; else ``t``."""
    if not _dispatch.is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise NotImplementedError when autograd would record a hand-written
    kernel's route: the kernels have no backward, and on a card they return
    tensors that autograd does not track, so a gradient would be dropped
    without a word. The reference refuses the same (``jax.grad`` through
    its ``pallas_call`` raises). Raised on every device, the CPU's plain
    path included, so that both refuse alike."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward, as the reference's Pallas kernel has "
            "none (jax.grad through its pallas_call raises): train with "
            "the plain route (attention_impl 'dense' or 'chunked', "
            "use_pallas_norm=False, use_kernel=False), or run this under "
            "torch.no_grad()")


def _inv_sqrt(d: int) -> float:
    """1 / sqrt(d) rounded as float32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
             call: Optional[CallConfig] = None) -> torch.Tensor:
    """The kernel path multiplies by ``w`` in fp32 and then casts to
    ``x.dtype``; the plain path casts first and then multiplies (so it
    returns the promoted dtype). In fp32 the two agree; in bf16 they round
    differently, as in the reference."""
    if call is not None and call.use_pallas_norm and x.dim() >= 2:
        refuse_grad("use_pallas_norm (the RMSNorm kernel)", x, w)
        return rmsnorm_ops.rmsnorm(x, w, eps=eps,
                                   backend=call.kernel_backend)
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def head_rms_norm(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: normalize over the head dim. x: [..., Dh], w: [Dh]."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S], [1, S] or [S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [Dh/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # [B, S, Dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    cos, sin = replicated(cos, x), replicated(sin, x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

KvLen = Union[int, torch.Tensor]


def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,Kh,G,D]."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _lengths(kv_len: KvLen, device: torch.device) -> torch.Tensor:
    """``kv_len`` (an int, or a scalar or [B] tensor) as a 1-D tensor."""
    if isinstance(kv_len, torch.Tensor):
        return kv_len.to(device).reshape(-1)
    return torch.full((1,), int(kv_len), dtype=torch.int64, device=device)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_pos: Optional[torch.Tensor] = None,
                    kv_len: Optional[KvLen] = None) -> torch.Tensor:
    """Reference attention, materializes scores.

    q: [B,Sq,H,D], k/v: [B,Sk,Kh,D].  GQA by head grouping.
    ``kv_len``: optional int, scalar or [B] — mask cache positions >=
    kv_len. ``q_pos``: positions of the queries (for causal masking vs
    absolute kv idx).
    """
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = _gqa_expand(q, kh)                                  # [B,Sq,Kh,G,D]
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * _inv_sqrt(d)
    t_idx = torch.arange(k.shape[1], device=q.device)
    if causal:
        qp = q_pos if q_pos is not None else torch.arange(sq,
                                                          device=q.device)
        mask = t_idx[None, :] <= qp[:, None]                 # [Sq, Sk]
        logits = logits.masked_fill(~mask[None, None, None], float("-inf"))
    if kv_len is not None:
        kvl = _lengths(kv_len, q.device).expand(b)
        valid = t_idx[None, :] < kvl[:, None]                # [B, Sk]
        logits = logits.masked_fill(~valid[:, None, None, None, :],
                                    float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v)
    return out.reshape(b, sq, h, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 512,
                      q_pos: Optional[torch.Tensor] = None,
                      kv_len: Optional[KvLen] = None) -> torch.Tensor:
    """Flash-style online softmax over KV chunks — O(Sq·chunk) live
    scores. The decode attention over the KV cache. Same signature as
    dense_attention."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    nchunk = -(-sk // chunk)
    pad = nchunk * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = _gqa_expand(q, kh)
    scale = _inv_sqrt(d)
    dev = q.device
    qp = q_pos if q_pos is not None else torch.arange(sq, device=dev)
    kvl = None if kv_len is None else _lengths(kv_len, dev)
    neg = -1e30
    g = h // kh
    acc = torch.zeros((b, kh, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kh, g, sq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=dev)
    for ci in range(nchunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        t_idx = ci * chunk + torch.arange(chunk, device=dev)
        logits = torch.einsum("bqkgd,btkd->bkgqt", qg, kb).float() * scale
        # additive bias on small shapes — never a full-shape mask
        if causal:
            bias = torch.where(t_idx[None, :] <= qp[:, None], 0.0, neg)
            logits = logits + bias[None, None, None]
        if kvl is not None or pad:
            vl = (torch.full((b,), sk, device=dev) if kvl is None else kvl)
            vbias = torch.where(t_idx[None, :] < vl[:, None], 0.0, neg)
            logits = logits + vbias[:, None, None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vb.dtype), vb)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _chunk_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of the reference's ``flash_chunked``, returning (out,
    lse). Shapes as chunked_attention; Sk must be a multiple of chunk."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    nchunk = sk // chunk
    qg = _gqa_expand(q, kh)
    scale = _inv_sqrt(d)
    dev = q.device
    qp = torch.arange(sq, device=dev)
    g = h // kh
    acc = torch.zeros((b, kh, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kh, g, sq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=dev)
    for ci in range(nchunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        t_idx = ci * chunk + torch.arange(chunk, device=dev)
        logits = torch.einsum("bqkgd,btkd->bkgqt", qg, kb).float() * scale
        if causal:
            bias = torch.where(t_idx[None, :] <= qp[:, None], 0.0, -1e30)
            logits = logits + bias[None, None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # probabilities at compute precision, products summed in fp32
        pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vb.dtype).float(),
                     vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, chunk: int):
    """The reference's ``_flash_bwd``: recompute each KV chunk's
    probabilities from the saved lse; the products take their inputs at
    the KV dtype (``p`` and ``ds`` cast to it) and sum in fp32."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    nchunk = sk // chunk
    cdt = k.dtype
    qg = _gqa_expand(q, kh).float()                          # [b,q,kh,g,d]
    dog = _gqa_expand(dout, kh).float()
    og = _gqa_expand(out, kh).float()
    qg_c, dog_c = qg.to(cdt).float(), dog.to(cdt).float()
    scale = _inv_sqrt(d)
    dev = q.device
    qp = torch.arange(sq, device=dev)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dog, og)      # rowsum(dO * O)
    dq = torch.zeros((b, sq, kh, g, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for ci in range(nchunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        t_idx = ci * chunk + torch.arange(chunk, device=dev)
        logits = torch.einsum("bqkgd,btkd->bkgqt", qg, kb) * scale
        if causal:
            bias = torch.where(t_idx[None, :] <= qp[:, None], 0.0, -1e30)
            logits = logits + bias[None, None, None]
        p = torch.exp(logits - lse[..., None]).to(cdt).float()
        dvs.append(torch.einsum("bkgqt,bqkgd->btkd", p, dog_c))
        dp = torch.einsum("bqkgd,btkd->bkgqt", dog_c, vb)
        ds = (p * (dp - delta[..., None]) * scale).to(cdt).float()
        dq = dq + torch.einsum("bkgqt,btkd->bqkgd", ds, kb)
        dks.append(torch.einsum("bkgqt,bqkgd->btkd", ds, qg_c))
    return (dq.reshape(b, sq, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashChunked(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``flash_chunked``: the forward keeps
    only q, k, v, out and the lse [B, Kh, G, Sq]; the backward recomputes
    chunk by chunk (``_flash_bwd``), so no [Sq, Sk] tensor outlives a
    chunk."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        out, lse = _chunk_fwd_lse(q, k, v, causal=causal, chunk=chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.chunk = causal, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                                ctx.chunk)
        return dq, dk, dv, None, None


def flash_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, chunk: int) -> torch.Tensor:
    """The reference's ``flash_chunked``: the chunked online-softmax
    forward with its custom backward (``_FlashChunked``). Sk must be a
    multiple of ``chunk``."""
    return _FlashChunked.apply(q, k, v, causal, chunk)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, call: CallConfig,
                   q_pos: Optional[torch.Tensor] = None,
                   kv_len: Optional[KvLen] = None) -> torch.Tensor:
    if _dispatch.is_dtensor(q):
        if kv_len is not None and q.shape[1] == 1 and not isinstance(
                kv_len, torch.Tensor) and any(
                _dispatch.shard_dim(p) == 1 for p in k.placements):
            return _sp_decode_attention(q, k, v, int(kv_len))
        # each device attends its own batch rows or heads; a shard of S
        # (seq_axis) is gathered first
        pl = flash_ops.placements(q, k)

        def local(q, k, v):
            return attention_core(q, k, v, causal=causal, call=call,
                                  q_pos=q_pos, kv_len=kv_len)

        return _dispatch.local_call(local, (q, k, v), (pl, pl, pl), pl)
    full_self = (causal and kv_len is None and q_pos is None
                 and q.shape[1] == k.shape[1])
    if call.attention_impl == "pallas" and full_self:
        refuse_grad('attention_impl="pallas" (the flash attention kernel)',
                    q, k, v)
        return flash_ops.flash_attention(q, k, v, causal=True,
                                         backend=call.kernel_backend)
    if call.attention_impl in ("chunked", "pallas"):
        if full_self and k.shape[1] % call.attn_chunk == 0:
            return flash_chunked(q, k, v, True, call.attn_chunk)
        return chunked_attention(q, k, v, causal=causal,
                                 chunk=call.attn_chunk, q_pos=q_pos,
                                 kv_len=kv_len)
    return dense_attention(q, k, v, causal=causal, q_pos=q_pos,
                           kv_len=kv_len)


def _decode_partial(q, k, v, kv_len: int):
    """One device's share of a decode step's attention over its span of
    the cache: (out [B, 1, H, D] float32, normalised over the span; lse
    [B, 1, H] float32, -inf where the span holds no valid key)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    logits = torch.einsum("bqkgd,btkd->bkgqt", _gqa_expand(q, kh),
                          k).float() * _inv_sqrt(d)
    valid = torch.arange(k.shape[1], device=q.device) < kv_len
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)                                        # [b,kh,g,q]
    o = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype), v).float()
    o = o / torch.clamp(l[..., None], min=1e-30)
    lse = m + torch.log(l)
    return (o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d),
            lse.permute(0, 3, 1, 2).reshape(b, sq, h))


def _sp_decode_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """Decode attention against a DTensor KV cache sharded on S (SP
    decode), as the reference's sharding inserts it: each device attends
    over its own span of S (flash-decoding's split), and the spans'
    partial results are combined with their log-sum-exps, so the cache is
    never gathered; only [n, B, 1, H, D] partials are reduced. Batch and
    head shards stay as ``flash_ops.placements`` keeps them."""
    from torch.distributed.tensor import Replicate, Shard
    base = flash_ops.placements(q, k)
    kv_pl = _dispatch.even_shards(k, [
        Shard(1) if _dispatch.shard_dim(pk) == 1 else b
        for pk, b in zip(k.placements, base)])
    q_pl = tuple(Replicate() if _dispatch.shard_dim(p) == 1 else p
                 for p in kv_pl)
    out_pl = tuple(Shard(0) if _dispatch.shard_dim(p) == 1
                   else Shard(_dispatch.shard_dim(p) + 1)
                   if _dispatch.shard_dim(p) is not None else p
                   for p in kv_pl)
    start, n = _dispatch.local_span(k, 1, kv_pl)

    def local(q, k, v):
        o, lse = _decode_partial(q, k, v, max(0, min(kv_len - start, n)))
        return o[None], lse[None]

    o, lse = _dispatch.local_call(local, (q, k, v),
                                  (q_pl, tuple(kv_pl), tuple(kv_pl)),
                                  (out_pl, out_pl))
    w = torch.exp(lse - lse.amax(dim=0))                     # [n,B,1,H]
    out = (o * w[..., None]).sum(dim=0) / w.sum(dim=0)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention layers (self, with KV cache for decode; cross)
# ---------------------------------------------------------------------------

class Weights(nn.Module):
    """The named weights of one sublayer, as the reference's param dict
    holds them (``p.wq`` for ``p["wq"]``)."""

    def __init__(self, **weights: torch.Tensor):
        super().__init__()
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w))


def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """N(0, std²) draws of ``shape`` from ``gen``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=device) * std
    return x.to(dtype)


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype=torch.float32, device=None,
                   cross: bool = False) -> Weights:
    """The reference's shapes and scales: wq [d, q_dim], wk/wv [d, kv_dim]
    ~ N(0, 1/d), wo [q_dim, d] ~ N(0, 1/q_dim); zero bq/bk/bv with
    qkv_bias, unit q_norm/k_norm [Dh] with qk_norm, neither for a
    cross-attention layer (``cross``)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    w = {"wq": normal(gen, (d, qd), d ** -0.5, dtype, device),
         "wk": normal(gen, (d, kvd), d ** -0.5, dtype, device),
         "wv": normal(gen, (d, kvd), d ** -0.5, dtype, device),
         "wo": normal(gen, (qd, d), qd ** -0.5, dtype, device)}
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            w[name] = torch.zeros((n,), dtype=dtype, device=device)
    if cfg.qk_norm and not cross:
        for name in ("q_norm", "k_norm"):
            w[name] = torch.ones((cfg.head_dim,), dtype=dtype, device=device)
    return Weights(**w)


def _heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """[B, S, n*dh] -> [B, S, n, dh]. A DTensor whose last dim is sharded
    more ways than its n heads split evenly (kv_dim = 32 over a 4-wide
    "model" axis with 2 KV heads, say) is gathered on that dim first: its
    shards would cut heads apart."""
    if _dispatch.is_dtensor(t):
        last = t.dim() - 1
        ways = math.prod(t.device_mesh.size(m)
                         for m, q in enumerate(t.placements)
                         if _dispatch.shard_dim(q) == last)
        if n % ways:
            from torch.distributed.tensor import Replicate
            t = t.redistribute(placements=tuple(
                Replicate() if _dispatch.shard_dim(q) == last else q
                for q in t.placements))
    return t.reshape(t.shape[0], t.shape[1], n, dh)


def self_attention(p: Weights, x: torch.Tensor, *, cfg: ModelConfig,
                   call: CallConfig, positions: Union[int, torch.Tensor],
                   cache: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B,S,D]. Train/prefill: cache=None, positions [S] or [B,S];
    returns no cache (the reference's unused ``max_seq`` prefill cache is
    not ported). Decode: S==1 with cache {'k','v'} of [B, Smax, Kh, Dh]
    and positions the int position being written. The port writes the
    new K/V row into the cache tensors in place and returns them; a
    position outside [0, Smax) raises (the reference's
    dynamic_update_slice would clamp it)."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = _heads(q, h, dh), _heads(k, kh, dh), _heads(v, kh, dh)
    if cfg.qk_norm:
        q = head_rms_norm(q, p.q_norm, cfg.norm_eps)
        k = head_rms_norm(k, p.k_norm, cfg.norm_eps)
    if call.gqa_expand_kv and kh < h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
        kh = h
    decode = cache is not None and s == 1
    if decode:
        pos = int(positions)
        rope_pos = torch.full((1, 1), pos, dtype=torch.int64,
                              device=x.device)
    else:
        rope_pos = positions if positions.dim() == 2 \
            else positions.reshape(1, -1)
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)

    new_cache = None
    if decode:
        ck, cv = cache["k"], cache["v"]
        if not 0 <= pos < ck.shape[1]:
            raise ValueError(f"decode position {pos} outside the cache's "
                             f"{ck.shape[1]} slots")
        _write_row(ck, pos, k)
        _write_row(cv, pos, v)
        new_cache = {"k": ck, "v": cv}
        out = attention_core(q, ck, cv, causal=False, call=call,
                             kv_len=pos + 1)
    else:
        out = attention_core(q, k, v, causal=True, call=call)
    out = out.reshape(b, s, h * dh)
    return out @ p.wo, new_cache


def _write_row(cache: torch.Tensor, pos: int, row: torch.Tensor) -> None:
    """cache[:, pos] = row[:, 0], in place. A DTensor cache sharded on S
    (SP decode) is written by the device that holds position ``pos``
    alone: ``row`` is redistributed to the cache's placements with S
    whole, and each device writes its local rows where ``pos`` falls in
    its span of S."""
    if not _dispatch.is_dtensor(cache):
        cache[:, pos] = row[:, 0]
        return
    from torch.distributed.tensor import Replicate
    row = row.redistribute(cache.device_mesh, tuple(
        Replicate() if _dispatch.shard_dim(p) == 1 else p
        for p in cache.placements)).to_local()
    start, n = _dispatch.local_span(cache, 1)
    if start <= pos < start + n:
        cache.to_local()[:, pos - start] = row[:, 0]


def cross_attention(p: Weights, x: torch.Tensor, mem: torch.Tensor, *,
                    cfg: ModelConfig, call: CallConfig) -> torch.Tensor:
    """x: [B,S,D] attends to mem: [B,M,D] (the stub modality embeddings),
    as the reference's ``cross_attention`` (``layers.py:388-396``): no
    RoPE, no mask, no bias or qk-norm. Under "pallas" and "chunked" it
    takes the padded ``chunked_attention`` (M = 1601 is a multiple of no
    chunk; the flash kernel serves causal self-attention only), under
    "dense" ``dense_attention``. Decode re-projects ``mem`` every step."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(x @ p.wq, h, dh)
    k, v = _heads(mem @ p.wk, kh, dh), _heads(mem @ p.wv, kh, dh)
    out = attention_core(q, k, v, causal=False, call=call)
    return out.reshape(b, s, h * dh) @ p.wo


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int,
             dtype=torch.float32, device=None) -> Weights:
    """The reference's shapes and scales: w_gate/w_up [d, d_ff] ~
    N(0, 1/d), w_down [d_ff, d] ~ N(0, 1/d_ff)."""
    d = cfg.d_model
    return Weights(w_gate=normal(gen, (d, d_ff), d ** -0.5, dtype, device),
                   w_up=normal(gen, (d, d_ff), d ** -0.5, dtype, device),
                   w_down=normal(gen, (d_ff, d), d_ff ** -0.5, dtype,
                                  device))


def swiglu(p: Weights, x: torch.Tensor) -> torch.Tensor:
    g = x @ p.w_gate
    u = x @ p.w_up
    return (F.silu(g) * u) @ p.w_down
