"""Carry env and simulator state across from the JAX reference.

The reference's env dict (``repro.core.netsim.build_env``) and scan carry
(``{"m": mandator state, "s": sporades state}``) have the same keys and
per-lane shapes as the port's; the port adds a leading lane axis ``B``.
These helpers take the reference's trees as numpy arrays (one lane, or
already batched) and return the port's tensors with matching dtypes, and
back. The tests use them to start both packages from one mid-run state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import device as _device


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
