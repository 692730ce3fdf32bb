"""Deterministic synthetic token pipeline: seeded, shardable, restartable
(port of ``repro.data.pipeline``).

Every (step, host) pair derives its shard of the global batch purely from
(seed, step, shard), so a restart or an elastic rescale replays exact
batches. A Zipfian unigram over the vocab plus a position-dependent drift
(x_t + 7t mod vocab/7) gives a learnable distribution.

The shard's key is the reference's, ``fold_in(fold_in(PRNGKey(seed),
step), shard)``, computed by ``core/coin.py``'s threefry; the draws are the
port's own: the key seeds a ``torch.Generator`` on the batch's device, and
``torch.multinomial`` samples the Zipf unigram (the reference's
``jax.random.categorical`` takes a Gumbel argmax over [b, s+1, vocab]
draws). So the batches follow the reference's distribution but are not
its tokens, and they differ between the CPU and a card; a comparison of
the two packages carries the reference's batches across.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import coin


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_exponent: float = 1.1
    markov_shift: int = 7     # next-token bias: x_{t+1} ~ (x_t * a + c) pattern


def _zipf_logits(vocab: int, exponent: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -exponent * torch.log(ranks)


def _shard_generator(dcfg: DataConfig, step: int, shard: int,
                    device) -> torch.Generator:
    """A generator on ``device`` seeded with the 64 bits of the reference's
    shard key fold_in(fold_in(PRNGKey(seed), step), shard)."""
    key = coin.fold_in(coin.fold_in(coin.prng_key(dcfg.seed),
                                    np.uint32(step)), np.uint32(shard))
    gen = torch.Generator(device=device)
    gen.manual_seed((int(key[0]) << 32) | int(key[1]))
    return gen


def global_batch(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
                 step: int, device=None) -> Dict[str, torch.Tensor]:
    """Materialize the full global batch for ``step`` (test/CPU scale)."""
    return batch_shard(cfg, shape, dcfg, step, shard=0, n_shards=1,
                       device=device)


def batch_shard(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
                step: int, shard: int, n_shards: int, device=None
                ) -> Dict[str, torch.Tensor]:
    """The per-host shard of the global batch, a pure function of (seed,
    step, shard, n_shards) and the device: tokens (or frame_emb) and
    labels [B/n_shards, S] int32, the labels the tokens shifted by one;
    vision_mem for a cross-attention config. ``device=None`` means
    CUDA."""
    if shape.global_batch % n_shards:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"split into {n_shards} shards")
    dev = _device.resolve(device)
    b = shape.global_batch // n_shards
    s = shape.seq_len
    gen = _shard_generator(dcfg, step, shard, dev)
    probs = torch.softmax(_zipf_logits(cfg.vocab, dcfg.zipf_exponent, dev),
                          dim=0)
    base = torch.multinomial(probs, b * (s + 1), replacement=True,
                             generator=gen).reshape(b, s + 1)
    # inject learnable sequential structure
    t = torch.arange(s + 1, device=dev)
    drift = (t * dcfg.markov_shift) % max(cfg.vocab // 7, 1)
    tokens = (base + drift[None, :]) % cfg.vocab
    out: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        out["tokens"] = tokens[:, :s].to(torch.int32)
    else:
        out["frame_emb"] = 0.02 * torch.randn((b, s, cfg.d_model),
                                              generator=gen, device=dev)
    out["labels"] = tokens[:, 1:s + 1].to(torch.int32)
    if cfg.cross_attn is not None:
        out["vision_mem"] = 0.02 * torch.randn(
            (b, cfg.cross_attn.n_mem_tokens, cfg.d_model), generator=gen,
            device=dev)
    return out
