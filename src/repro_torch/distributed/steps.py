"""Train, prefill and decode steps (port of ``repro.distributed.steps``).

train_step: loss -> backward -> AdamW update (optionally int8 moments).
serve_step: one decode token against the KV cache.
prefill_step: the next token after a prompt.

The reference's ``input_specs`` / ``cache_specs`` (the dry run's
stand-ins) belong to the mesh tooling, ROADMAP A17.7.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                loss_fn)
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


def make_serve_step(cfg: ModelConfig, call: CallConfig):
    """serve_step(params, cache, batch, pos) -> (argmax token [B] int32,
    cache)."""

    def serve_step(params, cache, batch: Dict, pos: int):
        logits, cache = forward_decode(params, cfg, call, batch, cache, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, call: CallConfig):
    """prefill_step(params, batch) -> the argmax token [B] int32 after the
    last position."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict):
        logits, _ = forward_train(params, cfg, call, batch)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return prefill_step
