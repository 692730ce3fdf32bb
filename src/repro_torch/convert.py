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
``DecoderLM`` is entry ``r`` of ``blocks[i]``, for every layer kind
alike (the mixer's leaves keep their names: ``wq ...``, ``w_in conv_w
conv_b w_bc w_dt dt_bias A_log D w_out`` (Mamba), ``wq wk wv w_i b_i w_f
b_f w_og b_og w_out`` (mLSTM) or ``w_{i,f,z,o} b_{i,f,z,o} r_{i,f,z,o}
w_out`` (sLSTM); a cross-attention layer adds ``cross_norm`` and
``cross``'s ``wq wk wv wo``; a MoE layer's ``moe`` holds ``router w_gate
w_up w_down`` and, for arctic, ``dense``'s SwiGLU leaves). Its cache has
the same stacking: ``{'k', 'v'}`` for an attention position, ``{'conv',
'h'}`` for a Mamba one, ``{'C', 'n', 'm'}`` for an mLSTM one and ``{'c',
'n', 'h', 'm'}`` for an sLSTM one.
``model_params_from_reference`` and ``model_params_to_reference`` map the
params both ways (the latter also a same-keyed gradient dict),
``weights_from_reference`` reads one sublayer's (a Mamba mixer's, say);
``opt_state_from_reference`` and ``opt_state_to_reference`` map the AdamW
state (``optim/adamw.py``: ``step``, and ``m`` and ``v`` keyed by
parameter name, a leaf either a float32 tensor or an int8 ``{'q', 's'}``
pair) to the reference's tree of the params' shape and back;
``cache_from_reference`` and ``cache_to_numpy`` map the caches both ways.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

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


def _state_from_reference(params_np: Dict, period: int
                          ) -> Dict[str, torch.Tensor]:
    """The reference's param tree as the port's state dict (CPU tensors)."""
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
    return state


def load_params_from_reference(params: _model.DecoderLM,
                               params_np: Dict) -> _model.DecoderLM:
    """Write the reference's param tree (numpy leaves) into ``params`` in
    place, each leaf cast to its parameter's dtype and device; every name
    and shape must match."""
    params.load_state_dict(
        _state_from_reference(params_np, params.cfg.block_period),
        strict=True)
    return params


def model_params_from_reference(params_np: Dict, cfg: ModelConfig,
                                device=None) -> _model.DecoderLM:
    """The reference's param tree (numpy leaves, float32 or bfloat16) as
    the port's DecoderLM on ``device`` (None = CUDA)."""
    dev = _device.resolve(device)
    dtype = _leaf(params_np["final_norm"]).dtype
    return load_params_from_reference(
        _model.init_params(cfg, 0, dtype, dev), params_np)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 (which numpy has no type for) as its
    float32 values."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _ref_path(name: str, period: int):
    """A port parameter name -> (its path in the reference's tree, the
    repeat r its leaf stacks at, or None outside ``blocks``)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return parts, None
    r, i = divmod(int(parts[1]), period)
    return ["blocks", i] + parts[2:], r


def _ref_leaf(tree: Dict, name: str, period: int):
    """The reference tree's leaf for port name ``name``: a numpy array, or
    a dict of arrays (an int8 moment's {'q', 's'}), at its repeat."""
    path, r = _ref_path(name, period)
    node = tree
    for key in path:
        node = node[key]
    if r is None:
        return node
    if isinstance(node, dict):
        return {k: np.asarray(v)[r] for k, v in node.items()}
    return np.asarray(node)[r]


def _named_to_tree(named: Mapping[str, Any], cfg: ModelConfig) -> Dict:
    """{port name: numpy leaf or dict of them} -> the reference's nested
    tree, ``blocks`` stacked [R, ...] per super-block position."""
    period = cfg.block_period
    repeats = cfg.n_layers // period
    tree: Dict = {}
    stacks: Dict = {}
    for name, leaf in named.items():
        path, r = _ref_path(name, period)
        if r is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        else:
            stacks.setdefault(tuple(path), [None] * repeats)[r] = leaf
    if stacks:
        tree["blocks"] = [{} for _ in range(period)]
    for path, leaves in stacks.items():
        node = tree["blocks"][path[1]]
        for key in path[2:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = ({k: np.stack([lf[k] for lf in leaves])
                           for k in leaves[0]}
                          if isinstance(leaves[0], dict)
                          else np.stack(leaves))
    return tree


def model_params_to_reference(params: Union[_model.DecoderLM,
                                            Mapping[str, torch.Tensor]],
                              cfg: Optional[ModelConfig] = None) -> Dict:
    """The port's DecoderLM (or a dict of tensors keyed by its parameter
    names, a gradient dict say) as the reference's param tree with numpy
    leaves (bfloat16 as float32). ``cfg`` defaults to the model's own."""
    if isinstance(params, nn.Module):
        cfg = cfg or params.cfg
        params = dict(params.named_parameters())
    return _named_to_tree({n: to_numpy(t) for n, t in params.items()}, cfg)


def _slot_to_numpy(slot):
    if isinstance(slot, dict):
        return {k: to_numpy(v) for k, v in slot.items()}
    return to_numpy(slot)


def opt_state_to_reference(state: Dict, cfg: ModelConfig) -> Dict:
    """The port's AdamW state as the reference's ``init_opt_state`` tree
    (numpy leaves)."""
    return {"step": np.asarray(to_numpy(state["step"]), np.int32),
            "m": _named_to_tree({n: _slot_to_numpy(v)
                                 for n, v in state["m"].items()}, cfg),
            "v": _named_to_tree({n: _slot_to_numpy(v)
                                 for n, v in state["v"].items()}, cfg)}


def opt_state_from_reference(tree_np: Dict, params: _model.DecoderLM,
                             device=None) -> Dict:
    """The reference's AdamW state (numpy leaves) as the port's, keyed by
    ``params``' names, on ``device`` (None = CUDA)."""
    dev = _device.resolve(device)
    period = params.cfg.block_period

    def slot(tree, name):
        leaf = _ref_leaf(tree, name, period)
        if isinstance(leaf, dict):
            return {k: _leaf(v).to(dev) for k, v in leaf.items()}
        return _leaf(leaf).to(dev)

    names = [n for n, _ in params.named_parameters()]
    return {"step": torch.as_tensor(np.asarray(tree_np["step"], np.int32),
                                    device=dev),
            "m": {n: slot(tree_np["m"], n) for n in names},
            "v": {n: slot(tree_np["v"], n) for n in names}}


def weights_from_reference(tree_np: Dict, device=None) -> Weights:
    """One sublayer's param dict of the reference (numpy leaves, e.g. the
    ``init_mamba`` or ``init_moe`` dict; a nested dict becomes a nested
    ``Weights``) as the port's ``Weights`` on ``device``."""
    dev = _device.resolve(device)
    w = Weights(**{k: _leaf(v).to(dev) for k, v in tree_np.items()
                   if not isinstance(v, dict)})
    for k, v in tree_np.items():
        if isinstance(v, dict):           # a nested sublayer (moe "dense")
            setattr(w, k, weights_from_reference(v, dev))
    return w


def cache_from_reference(cache_np: List[Dict], cfg: ModelConfig,
                         device=None) -> List[Dict[str, torch.Tensor]]:
    """The reference's cache (one dict per super-block position: {'k',
    'v'} with leaves [R, B, S, Kh, Dh]; a Mamba layer's {'conv', 'h'},
    [R, B, K-1, Di] and [R, B, Di, N]; an mLSTM layer's {'C', 'n', 'm'},
    [R, B, H, dh, dh], [R, B, H, dh] and [R, B, H]; an sLSTM layer's {'c',
    'n', 'h', 'm'}, each [R, B, Di]) as the port's per-layer list."""
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
    """The port's per-layer cache in the reference's layout (bfloat16
    leaves as their float32 values)."""
    period = cfg.block_period
    out = []
    for i in range(period):
        layers = cache[i::period]
        out.append({k: np.stack([to_numpy(c[k]) for c in layers])
                    for k in layers[0]})
    return out
