"""Carry env, simulator state, model weights and KV caches across from the
JAX reference.

The reference's env dict (``repro.core.netsim.build_env``) and scan carry
(``{"m": mandator state, "s": sporades state}``) have the same keys and
per-lane shapes as the port's; the port adds a leading lane axis ``B``.
These helpers take the reference's trees as numpy arrays (one lane, or
already batched) and return the port's tensors with matching dtypes, and
back. The tests use them to start both packages from one mid-run state.

The reference's model params (``repro.models.init_params``) stack every
``blocks`` leaf ``[R, ...]`` over the R repeats of a super-block of
``cfg.block_period`` layers; layer ``r * period + i`` of the port's
``DecoderLM`` is entry ``r`` of ``blocks[i]``, for attention and Mamba
layers alike (the mixer's leaves keep their names: ``wq ...`` or
``w_in conv_w conv_b w_bc w_dt dt_bias A_log D w_out``). Its cache has
the same stacking: ``{'k', 'v'}`` for an attention position,
``{'conv', 'h'}`` for a Mamba one. ``model_params_from_reference`` reads
the params, ``weights_from_reference`` one sublayer's (a Mamba mixer's,
say); ``cache_from_reference`` and ``cache_to_numpy`` map the caches both
ways.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as _model
from repro_torch.models.layers import Weights


def _tree_to_torch(tree, add_lane: bool, device: torch.device):
    if isinstance(tree, dict):
        return {k: (_tree_to_torch(v, add_lane, device) if k != "coins"
                    else _tree_to_torch(v, add_lane, device).long())
                for k, v in tree.items()}
    x = torch.as_tensor(np.array(tree), device=device)
    return x[None] if add_lane else x


def env_from_reference(env_np: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The reference's env dict (numpy leaves, one grid point or a stack of
    them) as the port's batched env on ``device`` (None = CUDA)."""
    dev = _device.resolve(device)
    add_lane = np.ndim(env_np["delays"]) == 2
    return _tree_to_torch(env_np, add_lane, dev)


def state_from_reference(tree_np: Dict, device=None) -> Dict:
    """The reference's ``{"m": ..., "s": ...}`` scan carry (numpy leaves,
    one lane or batched) as the port's batched carry on ``device``. The
    coin table becomes int64, as the port keeps it."""
    dev = _device.resolve(device)
    add_lane = np.ndim(tree_np["m"]["own_round"]) == 1
    return _tree_to_torch(tree_np, add_lane, dev)


def state_to_numpy(tree) -> Dict:
    """A port state tree (tensors, leading lane axis kept) as numpy."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _flatten(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _leaf(a) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (numpy's ml_dtypes type, which
    torch does not read) goes through float32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def model_params_from_reference(params_np: Dict, cfg: ModelConfig,
                                device=None) -> _model.DecoderLM:
    """The reference's param tree (numpy leaves, float32 or bfloat16) as
    the port's DecoderLM on ``device`` (None = CUDA)."""
    dev = _device.resolve(device)
    period = cfg.block_period
    state = {}
    for key, value in params_np.items():
        if key != "blocks":
            state[key] = _leaf(value)
            continue
        for i, block in enumerate(value):
            for name, leaf in _flatten(block):
                leaf = np.asarray(leaf)
                for r in range(leaf.shape[0]):
                    state[f"layers.{r * period + i}.{name}"] = _leaf(leaf[r])
    params = _model.init_params(cfg, 0, state["final_norm"].dtype, dev)
    params.load_state_dict(state, strict=True)   # every name and shape
    return params


def weights_from_reference(tree_np: Dict, device=None) -> Weights:
    """One sublayer's param dict of the reference (numpy leaves, e.g. the
    ``init_mamba`` dict) as the port's ``Weights`` on ``device``."""
    dev = _device.resolve(device)
    return Weights(**{k: _leaf(v).to(dev) for k, v in tree_np.items()})


def cache_from_reference(cache_np: List[Dict], cfg: ModelConfig,
                         device=None) -> List[Dict[str, torch.Tensor]]:
    """The reference's cache (one dict per super-block position: {'k',
    'v'} with leaves [R, B, S, Kh, Dh], or a Mamba layer's {'conv', 'h'}
    with leaves [R, B, K-1, Di] and [R, B, Di, N]) as the port's per-layer
    list."""
    dev = _device.resolve(device)
    period = cfg.block_period
    out = []
    for layer in range(cfg.n_layers):
        r, i = divmod(layer, period)
        out.append({k: _leaf(np.asarray(v)[r]).to(dev)
                    for k, v in cache_np[i].items()})
    return out


def cache_to_numpy(cache: List[Dict[str, torch.Tensor]],
                   cfg: ModelConfig) -> List[Dict[str, np.ndarray]]:
    """The port's per-layer cache in the reference's layout."""
    period = cfg.block_period
    out = []
    for i in range(period):
        layers = cache[i::period]
        out.append({k: np.stack([c[k].detach().cpu().numpy()
                                 for c in layers])
                    for k in layers[0]})
    return out
