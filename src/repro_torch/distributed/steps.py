"""Train, prefill and decode steps (port of ``repro.distributed.steps``).

train_step: loss -> backward -> AdamW update (optionally int8 moments).
serve_step: one decode token against the KV cache.
prefill_step: the next token after a prompt.

The steps take DTensor parameters, state, batch and caches as they are
(``distributed/sharding.py`` places them). ``input_specs`` and
``cache_specs`` are the dry run's stand-ins: ``meta`` tensors of every
input's shape and dtype, which allocate nothing.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import _dispatch
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                init_cache, loss_fn)
from repro_torch.optim.adamw import AdamWConfig, apply_updates


def make_train_step(cfg: ModelConfig, call: CallConfig, opt: AdamWConfig):
    """train_step(params, opt_state, batch) -> (params, updated in place;
    opt_state; metrics {"loss", "nll", "aux", "zloss", "grad_norm",
    "lr"}, 0-dim tensors on the params' device)."""

    def train_step(params, opt_state, batch: Dict):
        params.zero_grad(set_to_none=True)
        loss, parts = loss_fn(params, cfg, call, batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.named_parameters()}
        params, opt_state, om = apply_updates(opt, params, grads, opt_state)
        params.zero_grad(set_to_none=True)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return params, opt_state, metrics

    return train_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim (V) as int32, the first index of the max.
    For a DTensor with V sharded each device takes its own shard's max and
    first argmax, and the shards' [n, B] candidates are gathered and
    compared (the first shard holding the max wins): the logits are never
    gathered."""
    if not _dispatch.is_dtensor(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from torch.distributed.tensor import Replicate, Shard
    last = logits.dim() - 1
    pl = [q if _dispatch.shard_dim(q) == last else Replicate()
          for q in logits.placements]
    pl = _dispatch.even_shards(logits, pl)
    v0, _ = _dispatch.local_span(logits, last, pl)
    cand = tuple(Shard(0) if _dispatch.shard_dim(q) == last else Replicate()
                 for q in pl)

    def local(lg):
        val, idx = lg.max(dim=-1)
        return val[None], (idx + v0)[None]

    val, idx = _dispatch.local_call(local, (logits,), (tuple(pl),),
                                    (cand, cand))
    rep = (Replicate(),) * len(pl)
    val, idx = val.redistribute(placements=rep).to_local(), \
        idx.redistribute(placements=rep).to_local()
    best = torch.argmax(val, dim=0)
    return torch.gather(idx, 0, best[None])[0].to(torch.int32)


def make_serve_step(cfg: ModelConfig, call: CallConfig):
    """serve_step(params, cache, batch, pos) -> (argmax token [B] int32,
    cache)."""

    def serve_step(params, cache, batch: Dict, pos: int):
        logits, cache = forward_decode(params, cfg, call, batch, cache, pos)
        return greedy(logits), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, call: CallConfig):
    """prefill_step(params, batch) -> the argmax token [B] int32 after the
    last position."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict):
        logits, _ = forward_train(params, cfg, call, batch)
        return greedy(logits[:, -1])

    return prefill_step


# ---------------------------------------------------------------------------
# input specs (meta-tensor stand-ins; no allocation) — the dry run's contract
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of the given workload shape: train
    tokens (or frame_emb) and labels [B, S]; prefill the same without
    labels; decode one token [B] (or frame_emb [B, 1, D]) against a cache
    of seq_len; vision_mem [B, M, D] where the config cross-attends."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    batch: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        batch["tokens" if cfg.embed_inputs else "frame_emb"] = (
            _spec((b, s), i32) if cfg.embed_inputs
            else _spec((b, s, cfg.d_model), dtype))
        if shape.kind == "train":
            batch["labels"] = _spec((b, s), i32)
    else:
        batch["tokens" if cfg.embed_inputs else "frame_emb"] = (
            _spec((b,), i32) if cfg.embed_inputs
            else _spec((b, 1, cfg.d_model), dtype))
    if cfg.cross_attn is not None:
        batch["vision_mem"] = _spec((b, cfg.cross_attn.n_mem_tokens,
                                     cfg.d_model), dtype)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    """``init_cache``'s per-layer list for the shape, as meta tensors."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                      device="meta")
