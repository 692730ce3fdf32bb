"""Batched serving driver: prefill + decode with the KV / recurrent cache.

The prompt is fed token by token through ``forward_decode`` (exact with
the cache), then greedy decoding runs, as the reference's
``repro.launch.serve`` does. A config with cross-attention gets the
reference's stub memory (``vision_mem``, the frontend is not modelled),
passed to every decode step. Runs on CUDA unless ``device`` names another
device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --batch 4 --prompt-len 16 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (CallConfig, forward_decode, init_cache,
                                init_params)
from repro_torch.models.model import DecoderLM


def greedy_generate(params: DecoderLM, cfg: ModelConfig, call: CallConfig,
                    pbatch: Dict, cache: List[dict], prompt_len: int,
                    gen: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Feed the prompt (tokens [B, P] or frame_emb [B, P, D]) token by
    token, then pick the argmax token ``gen`` times; the cache must hold
    ``prompt_len + gen`` positions. Every other key of ``pbatch`` (the
    ``vision_mem`` of a cross-attention config) goes to every step.
    Returns (tokens [B, gen] int32, the logits [B, V] of each step whose
    argmax was taken)."""
    max_seq = prompt_len + gen
    logits = None
    for t in range(prompt_len):
        db = dict(pbatch)
        if cfg.embed_inputs:
            db["tokens"] = pbatch["tokens"][:, t]
        else:
            db["frame_emb"] = pbatch["frame_emb"][:, t:t + 1]
        logits, cache = forward_decode(params, cfg, call, db, cache, t)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out_tokens, out_logits = [tok], [logits]
    for t in range(prompt_len, max_seq - 1):
        db = dict(pbatch)
        if cfg.embed_inputs:
            db["tokens"] = tok
        else:
            db["frame_emb"] = 0.0 * pbatch["frame_emb"][:, :1]
        logits, cache = forward_decode(params, cfg, call, db, cache, t)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out_tokens.append(tok)
        out_logits.append(logits)
    return torch.stack(out_tokens, dim=1), out_logits


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 16, gen: int = 32, seed: int = 0,
          greedy: bool = True, verbose: bool = True, device=None) -> Dict:
    """Random weights, a random prompt and, for a cross-attention config,
    the stub memory 0.02 * N(0, 1) [batch, n_mem_tokens, d_model], all
    from ``seed``; prefill, greedy decode. Returns {"tokens": [batch, gen]
    numpy int32, "seconds": wall time of prefill and decode,
    synchronized}."""
    dev = _device.resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    call = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                      remat=False)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    params = init_params(cfg, rng, device=dev)
    max_seq = prompt_len + gen
    cache = init_cache(cfg, batch, max_seq, torch.float32, device=dev)

    pbatch: Dict = {}
    if cfg.embed_inputs:
        pbatch["tokens"] = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                         generator=rng, device=dev)
    else:
        pbatch["frame_emb"] = 0.02 * torch.randn(
            (batch, prompt_len, cfg.d_model), generator=rng, device=dev)
    if cfg.cross_attn is not None:
        pbatch["vision_mem"] = 0.02 * torch.randn(
            (batch, cfg.cross_attn.n_mem_tokens, cfg.d_model),
            generator=rng, device=dev)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        toks, _ = greedy_generate(params, cfg, call, pbatch, cache,
                                  prompt_len, gen)
    toks = toks.cpu().numpy()                 # waits for the device
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[serve] {arch}: batch={batch} prompt={prompt_len} "
              f"gen={toks.shape[1]} in {dt:.1f}s "
              f"({batch * toks.shape[1] / dt:.1f} tok/s) on {dev}")
        print("first sequence:", toks[0, :16])
    return {"tokens": np.asarray(toks), "seconds": dt}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args()
    serve(args.arch, reduced=args.reduced, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen)


if __name__ == "__main__":
    main()
