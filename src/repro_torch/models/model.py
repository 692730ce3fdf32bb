"""Decoder LM composition: embed -> layers -> norm -> head, for every
family of the reference: dense (every layer an ``attn`` mixer with a dense
SwiGLU MLP), MoE (a MoE MLP in place of the dense one, ``models/moe.py``),
the hybrid (``mamba`` mixers with ``attn`` between them and MoE every
other layer, as jamba interleaves them), xLSTM (``mlstm`` mixers with an
``slstm`` every eighth layer, no MLP) and the vision LM (``attn`` layers,
every fifth with a cross-attention sublayer over ``batch["vision_mem"]``).

The reference stacks parameters ``[R, ...]`` over repeats of a super-block
and scans over them; the port holds one module per layer in
``DecoderLM.layers`` and loops over them (``convert`` maps the two).

Under a mesh the parameters, batch and caches are DTensors placed by
``distributed/sharding.py``, and the activations are constrained
(``layers.constrain_act``) after the embedding and after each layer, as
the reference constrains them.

Entry points (the reference's names and signatures; ``device=None`` means
CUDA and raises without a card):
  init_params(cfg, key, dtype, device)                 -> DecoderLM
  forward_train(params, cfg, call, batch)              -> (logits, aux)
  init_cache(cfg, batch, max_seq, dtype, device)       -> [per-layer cache]
  forward_decode(params, cfg, call, batch, cache, pos) -> (logits, cache)
  loss_fn(params, cfg, call, batch)                    -> (loss, parts)

As in the reference (``model.py:173,267``), a Mamba layer of the model
scans with the chunked scan (whose custom backward keeps only chunk-start
states), not the ssm_scan kernel; ``ssm.mamba_forward(use_kernel=True)``
is the kernel's entry point.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _dispatch
from repro_torch.models import ssm
from repro_torch.models.moe import init_moe, moe_mlp
from repro_torch.models.layers import (CallConfig, constrain_act,
                                       cross_attention, normal,
                                       init_attention, init_mlp, rms_norm,
                                       self_attention, swiglu)

# the mixer kinds of ``ModelConfig.layer_kinds``
MIXERS = ("attn", "mamba", "mlstm", "slstm")
_INIT_MIXER = {"attn": init_attention, "mamba": ssm.init_mamba,
               "mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer, as the reference's ``_init_layer``: norm1 and the
    mixer of its ``kind`` (one of ``MIXERS``); where
    ``cfg.layer_has_cross_attn``, cross_norm and the cross-attention
    sublayer (``cross``); and norm2 with the MoE MLP (``moe``, where
    ``cfg.layer_has_moe``) or else, when d_ff, the SwiGLU MLP (``mlp``)."""

    def __init__(self, cfg: ModelConfig, kind: str, has_moe: bool,
                 has_cross: bool, gen: torch.Generator, dtype=torch.float32,
                 device=None):
        super().__init__()
        if kind not in MIXERS:
            raise ValueError(kind)
        self.kind = kind
        self.has_moe = has_moe
        ones = dict(dtype=dtype, device=device)
        self.norm1 = nn.Parameter(torch.ones((cfg.d_model,), **ones))
        self.mixer = _INIT_MIXER[kind](cfg, gen, dtype, device)
        self.cross = None
        if has_cross:
            self.cross_norm = nn.Parameter(torch.ones((cfg.d_model,), **ones))
            self.cross = init_attention(cfg, gen, dtype, device, cross=True)
        if has_moe:
            self.norm2 = nn.Parameter(torch.ones((cfg.d_model,), **ones))
            self.moe = init_moe(cfg, gen, dtype, device)
        elif cfg.d_ff:
            self.norm2 = nn.Parameter(torch.ones((cfg.d_model,), **ones))
            self.mlp = init_mlp(cfg, gen, cfg.d_ff, dtype, device)


class DecoderLM(nn.Module):
    """embed [V, d] (when the config embeds tokens), head [d, V] (when it
    is not tied), one ``Layer`` per layer, final_norm [d]; ``cfg`` is the
    config it was built for."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.final_norm = nn.Parameter(torch.ones((d,), dtype=dtype,
                                                  device=device))
        if cfg.embed_inputs:
            self.embed = nn.Parameter(
                normal(gen, (cfg.vocab, d), 0.02, dtype, device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                normal(gen, (d, cfg.vocab), d ** -0.5, dtype, device))
        self.layers = nn.ModuleList(
            Layer(cfg, kind, cfg.layer_has_moe(i), cfg.layer_has_cross_attn(i),
                  gen, dtype, device)
            for i, kind in enumerate(cfg.layer_kinds()))


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device=None) -> DecoderLM:
    """Random weights with the reference's shapes and scales
    (``model.py:61-83``): embed ~ N(0, 0.02²), head ~ N(0, 1/d), the
    layers as ``init_attention`` / ``ssm.init_{mamba,mlstm,slstm}`` /
    ``init_attention(cross=True)`` / ``init_moe`` / ``init_mlp``, norms at
    one. ``key`` is
    an int seed or a ``torch.Generator`` on ``device``. The values are the
    port's own draws, not JAX's."""
    dev = _device.resolve(device)
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    return DecoderLM(cfg, gen, dtype, dev)


def param_count_actual(params: DecoderLM) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, call: CallConfig, lp: Layer,
                 x: torch.Tensor, *, positions, mem: Optional[torch.Tensor],
                 cache: Optional[dict]
                 ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (x, the layer's new cache or None, its MoE MLP's aux loss
    or, without MoE, None)."""
    h = rms_norm(x, lp.norm1, cfg.norm_eps, call)
    if lp.kind == "attn":
        out, new_cache = self_attention(lp.mixer, h, cfg=cfg, call=call,
                                        positions=positions, cache=cache)
    elif cache is not None:
        out, new_cache = _batch_local(_DECODE[lp.kind], lp.mixer, h, cache,
                                      cfg=cfg)
    elif lp.kind == "mamba":
        out, new_cache = ssm.mamba_forward(lp.mixer, h, cfg=cfg), None
    else:
        out, new_cache = _batch_local(_FORWARD[lp.kind], lp.mixer, h,
                                      cfg=cfg), None
    x = x + out
    if lp.cross is not None:
        if mem is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "batch['vision_mem'] [B, M, D]")
        hc = rms_norm(x, lp.cross_norm, cfg.norm_eps, call)
        x = x + cross_attention(lp.cross, hc, mem, cfg=cfg, call=call)
    aux = None
    if lp.has_moe:
        h2 = rms_norm(x, lp.norm2, cfg.norm_eps, call)
        tok_axes = call.batch_axes + ((call.seq_axis,)
                                      if call.seq_axis else ())
        y, aux = moe_mlp(lp.moe, h2, cfg=cfg, ep_axis=call.moe_ep_axis,
                         group_size=call.moe_group_size, tok_axes=tok_axes)
        x = x + y
    elif cfg.d_ff:
        h2 = rms_norm(x, lp.norm2, cfg.norm_eps, call)
        x = x + swiglu(lp.mlp, h2)
    return x, new_cache, aux


_FORWARD = {"mlstm": ssm.mlstm_forward, "slstm": ssm.slstm_forward}


def _batch_local(fn, p: nn.Module, x: torch.Tensor, *state, cfg):
    """``fn(p, x, *state, cfg=cfg)``; with DTensor activations it runs on
    each device's batch rows through ``local_map``: the recurrent mixers
    (the xLSTM forwards, every recurrent decode step) are batch-local,
    so their weights and any channel shard of the state are gathered
    first (redistributed to Replicate), x and the state keep their batch
    shards, and the output and new state come back batch-sharded."""
    if not _dispatch.is_dtensor(x):
        return fn(p, x, *state, cfg=cfg)
    from torch.distributed.tensor import Replicate
    pl = tuple(_dispatch.even_shards(x, [
        q if _dispatch.shard_dim(q) == 0 else Replicate()
        for q in x.placements]))
    rep = (Replicate(),) * len(pl)
    names = [n for n, _ in p.named_parameters()]
    keys = list(state[0]) if state else []
    leaves = [state[0][k] for k in keys]

    def local(x, *rest):
        w = SimpleNamespace(**dict(zip(names, rest[:len(names)])))
        if not state:
            return fn(w, x, cfg=cfg)
        out, new = fn(w, x, dict(zip(keys, rest[len(names):])), cfg=cfg)
        return (out, *(new[k] for k in keys))

    ins = (x, *(q for _, q in p.named_parameters()), *leaves)
    out = _dispatch.local_call(
        local, ins, (pl, *(rep,) * len(names), *(pl,) * len(leaves)),
        (pl,) * (1 + len(leaves)) if state else pl)
    if not state:
        return out
    return out[0], dict(zip(keys, out[1:]))
_DECODE = {"mamba": ssm.mamba_decode, "mlstm": ssm.mlstm_decode,
           "slstm": ssm.slstm_decode}


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params: DecoderLM, cfg: ModelConfig, call: CallConfig,
           batch: Dict) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x, mem): the token embeddings (or ``frame_emb``) and the optional
    ``vision_mem`` [B, M, D], both cast to ``call.compute_dtype``."""
    x = _lookup(params.embed, batch["tokens"]) if cfg.embed_inputs \
        else batch["frame_emb"]
    mem = batch.get("vision_mem")
    return x.to(call.compute_dtype), (
        None if mem is None else mem.to(call.compute_dtype))


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed[tokens]. For a DTensor table sharded on V (the embed rule)
    each device looks up the tokens that fall in its span of V, zeros for
    the rest, and the rows are a pending sum over those devices (a
    vocab-parallel embedding: the table is never gathered). The tokens
    keep their batch shards on the other mesh dims; a shard of D is
    gathered first."""
    if not _dispatch.is_dtensor(embed):
        return embed[tokens]
    from torch.distributed.tensor import Partial, Replicate
    e_pl = _dispatch.even_shards(embed, [
        q if _dispatch.shard_dim(q) == 0 else Replicate()
        for q in embed.placements])
    t_pl, o_pl = [], []
    for qe, qt in zip(e_pl, tokens.placements):
        if _dispatch.shard_dim(qe) == 0:
            t_pl.append(Replicate()), o_pl.append(Partial())
        elif _dispatch.shard_dim(qt) == 0:
            t_pl.append(qt), o_pl.append(qt)
        else:
            t_pl.append(Replicate()), o_pl.append(Replicate())
    t_pl = _dispatch.even_shards(tokens, t_pl)
    o_pl = [o if _dispatch.shard_dim(o) is None or t == o else Replicate()
            for o, t in zip(o_pl, t_pl)]
    v0, nv = _dispatch.local_span(embed, 0, e_pl)

    def local(emb, tok):
        idx = tok.long() - v0
        inside = (idx >= 0) & (idx < nv)
        rows = emb[idx.clamp(0, nv - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return _dispatch.local_call(local, (embed, tokens),
                                (tuple(e_pl), tuple(t_pl)), tuple(o_pl))


def _head(params: DecoderLM, cfg: ModelConfig,
          x: torch.Tensor) -> torch.Tensor:
    w = params.embed.t() if cfg.tie_embeddings else params.head
    return (x @ w).float()


def forward_train(params: DecoderLM, cfg: ModelConfig, call: CallConfig,
                  batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens [B,S] (or frame_emb [B,S,D]), vision_mem [B,M,D]
    where the config has cross-attention. Returns (logits [B,S,V] fp32,
    aux_loss: a float32 scalar, the sum of the MoE layers' aux losses).
    Under ``call.remat`` and autograd each layer is recomputed in the
    backward pass (``torch.utils.checkpoint``)."""
    x, mem = _embed(params, cfg, call, batch)
    x = constrain_act(x, call)
    positions = torch.arange(x.shape[1], device=x.device)
    period = cfg.block_period

    def layer(lp, x, mem):
        x, _, aux = _apply_layer(cfg, call, lp, x, positions=positions,
                                 mem=mem, cache=None)
        return constrain_act(x, call), aux

    # as the reference: each super-block's aux summed in layer order (its
    # sum from zero: 0 + a is a), then the blocks' sums added
    block_aux: Dict[int, torch.Tensor] = {}
    for i, lp in enumerate(params.layers):
        if call.remat and torch.is_grad_enabled():
            x, aux = checkpoint(layer, lp, x, mem, use_reentrant=False)
        else:
            x, aux = layer(lp, x, mem)
        if aux is not None:
            r = i // period
            block_aux[r] = block_aux[r] + aux if r in block_aux else aux
    x = rms_norm(x, params.final_norm, cfg.norm_eps, call)
    aux = (torch.stack(list(block_aux.values())).sum() if block_aux
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return _head(params, cfg, x), aux


def _pick(shifted: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """shifted[..., labels]: [B, S, V], [B, S] -> [B, S]. For a DTensor
    with V sharded (the head is TP-sharded on V) each device picks the
    labels that fall in its span of V and the pick is a pending sum over
    those devices, as the reference's where-and-sum reduces: the [B, S, V]
    logits are never gathered. Batch shards stay; any other placement of
    V's dims is gathered first."""
    if not _dispatch.is_dtensor(shifted):
        return torch.gather(shifted, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    last = shifted.dim() - 1
    pl = _dispatch.even_shards(shifted, [
        q if _dispatch.shard_dim(q) in (0, last) else Replicate()
        for q in shifted.placements])
    lab = tuple(q if _dispatch.shard_dim(q) == 0 else Replicate()
                for q in pl)
    out = tuple(Partial() if _dispatch.shard_dim(q) == last else q
                for q in pl)
    v0, nv = _dispatch.local_span(shifted, last, pl)

    def local(sh, lb):
        idx = lb - v0
        inside = (idx >= 0) & (idx < nv)
        val = torch.gather(sh, -1, idx.clamp(0, nv - 1)[..., None])[..., 0]
        return torch.where(inside, val, torch.zeros_like(val))

    return _dispatch.local_call(local, (shifted, labels), (tuple(pl), lab),
                                out)


def loss_fn(params: DecoderLM, cfg: ModelConfig, call: CallConfig,
            batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn`` (``model.py:191-213``): the mean
    cross entropy over ``labels`` [B,S] (weighted by an optional
    ``loss_mask``) from the logits less their max (held out of the
    gradient), plus the MoE aux loss and a 1e-4 z-loss on the
    log-partition. Returns (total, {"nll", "aux", "zloss"})."""
    logits, aux = forward_train(params, cfg, call, batch)
    labels = batch["labels"].long()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    picked = _pick(shifted, labels)
    nll = lse - picked
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    nll = _dispatch.settled((nll * mask).sum()) / torch.clamp(
        _dispatch.settled(mask.sum()), min=1.0)
    zloss = 1e-4 * _dispatch.settled(torch.mean((lse + m[..., 0]) ** 2))
    total = nll + aux + zloss
    return total, {"nll": nll, "aux": aux, "zloss": zloss}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> List[dict]:
    """One cache per layer: {'k', 'v'} of [batch, max_seq, Kh, Dh] zeros for
    an attention layer, ``ssm.{mamba,mlstm,slstm}_init_state`` for the
    others (the reference stacks them [R, ...] per super-block position;
    ``convert.cache_to_numpy`` gives that layout). Cross-attention caches
    nothing: decode re-projects the memory every step, as the reference
    does."""
    dev = _device.resolve(device)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    states = {"mamba": ssm.mamba_init_state, "mlstm": ssm.mlstm_init_state,
              "slstm": ssm.slstm_init_state}

    def one(kind):
        if kind in states:
            return states[kind](cfg, batch, dtype, dev)
        if kind != "attn":
            raise ValueError(kind)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    return [one(kind) for kind in cfg.layer_kinds()]


@torch.no_grad()
def forward_decode(params: DecoderLM, cfg: ModelConfig, call: CallConfig,
                   batch: Dict, cache: List[dict], pos: int
                   ) -> Tuple[torch.Tensor, List[dict]]:
    """One decode step. batch: tokens [B] (or frame_emb [B,1,D]), and
    vision_mem [B,M,D] where the config has cross-attention. pos: the int
    position being written, in [0, max_seq) (a position outside raises;
    the reference would clamp it). An attention layer's cache is updated
    in place, a recurrent layer's (Mamba, mLSTM, sLSTM) is replaced by its
    new state: use the returned list. Returns (logits [B,V] fp32, cache)."""
    if len(cache) != cfg.n_layers:
        raise ValueError(f"cache has {len(cache)} layers, the config "
                         f"{cfg.n_layers}")
    if cfg.embed_inputs:
        batch = dict(batch, tokens=batch["tokens"][:, None])
    x, mem = _embed(params, cfg, call, batch)
    pos = int(pos)
    new_cache = []
    for lp, lc in zip(params.layers, cache):
        x, nc, _ = _apply_layer(cfg, call, lp, x, positions=pos, mem=mem,
                                cache=lc)
        new_cache.append(nc)
    x = rms_norm(x, params.final_norm, cfg.norm_eps, call)
    return _head(params, cfg, x)[:, 0], new_cache
