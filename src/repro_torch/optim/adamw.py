"""AdamW with optional row-quantized int8 moments (2 bytes a parameter of
optimizer state instead of 8, for the >=100B MoE archs) and an
error-feedback int8 gradient compressor for a data-parallel all-reduce
(port of ``repro.optim.adamw``).

Params are a module (its ``named_parameters``) or a dict of tensors keyed
by name; grads and the state's ``m`` / ``v`` are dicts with the same keys.
``apply_updates`` writes the new values into the params' tensors in place
and returns them with the new state. Step, learning rate and grad norm stay
0-dim tensors on the params' device: an update reads nothing back to the
host.

DTensor parameters, gradients and moments (``distributed/sharding.py``,
``launch/dryrun._opt_shardings``) update shard by shard: the global grad
norm reduces over every shard, a row scale over a sharded last dim
reduces over its shards, and each new value is redistributed to its
slot's placements before it is stored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import _dispatch

BLOCK = 256          # DP gradient-compression block (flat)
QUANT_MIN_SIZE = 1 << 22   # quantize moments only for leaves >= 4M params

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False      # int8 m/v (row-scaled)
    warmup_steps: int = 100


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _q8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the param's own last dim (per-row absmax scales), so
    the int8 state keeps the param's shape. Rounds half to even, as the
    reference's ``jnp.round``."""
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(x / torch.clamp(s, min=1e-12)).to(torch.int8)
    return q, s.float()


def _dq8_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def _quantizable(p: torch.Tensor, repeats: int = 1) -> bool:
    """The reference's rule on its leaf: ``repeats`` layers of ``p``'s
    shape stacked (a model's per-layer leaf; 1 elsewhere)."""
    return p.numel() * repeats >= QUANT_MIN_SIZE and p.dim() >= 1


def _repeats(params: Params) -> int:
    """How many layers the reference stacks into one leaf of a model's
    ``layers.*`` parameters: its quantization threshold is on that stack
    (a per-layer router of 0.9M elements is a 32M-element leaf there)."""
    cfg = getattr(params, "cfg", None)
    return 1 if cfg is None else cfg.n_layers // cfg.block_period


def _row_scale_zeros(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros [..., 1] for ``p``'s row scales; for a DTensor ``p``
    with its placements, a shard of the last dim replicated (the
    reference's ``_opt_shardings``: the scales' last dim is 1)."""
    shape = p.shape[:-1] + (1,)
    if not _dispatch.is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import DTensor, Replicate
    last = p.dim() - 1
    local = p.to_local()
    return DTensor.from_local(
        torch.zeros(local.shape[:-1] + (1,), dtype=torch.float32,
                    device=local.device),
        p.device_mesh, tuple(Replicate() if _dispatch.shard_dim(q) == last
                             else q for q in p.placements),
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def init_opt_state(cfg: AdamWConfig, params: Params) -> Dict[str, Any]:
    """{"step": int32 0, "m": {name: zeros}, "v": {name: zeros}}; a slot
    is float32 of the param's shape, or with ``quantized_state`` and a
    leaf of at least QUANT_MIN_SIZE elements {"q": int8 of its shape, "s":
    float32 [..., 1]}. A model's layer counts as the reference's stacked
    leaf of all its super-block position's layers (``_repeats``)."""
    named = _named(params)
    reps = _repeats(params)

    def zeros_like_q(n, p):
        if cfg.quantized_state and _quantizable(
                p, reps if n.startswith("layers.") else 1):
            return {"q": torch.zeros_like(p, dtype=torch.int8),
                    "s": _row_scale_zeros(p)}
        return torch.zeros_like(p, dtype=torch.float32)

    dev = next(iter(named.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {n: zeros_like_q(n, p) for n, p in named.items()},
            "v": {n: zeros_like_q(n, p) for n, p in named.items()}}


def _load(slot) -> torch.Tensor:
    if isinstance(slot, dict):
        return _dq8_rows(slot["q"], slot["s"])
    return slot


def _placed(val: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``val`` with ``like``'s placements when both are DTensors."""
    if _dispatch.is_dtensor(like):
        return val.redistribute(like.device_mesh, like.placements)
    return val


def _store(val: torch.Tensor, like):
    if isinstance(like, dict):
        q, s = _q8_rows(val)
        return {"q": _placed(q, like["q"]), "s": _placed(s, like["s"])}
    return _placed(val, like)


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params,
                  grads: Mapping[str, torch.Tensor], opt_state: Dict
                  ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step (``adamw.py:80-109``): clip by the global norm,
    linear warm-up, bias correction, decoupled weight decay on every leaf.
    Returns (params, updated in place; the new state; {"grad_norm",
    "lr"})."""
    named = _named(params)
    step = opt_state["step"] + 1
    stepf = step.float()
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = cfg.lr * torch.clamp(stepf / cfg.warmup_steps, max=1.0)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    new_m, new_v = {}, {}
    for name, p in named.items():
        m0, v0 = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].float() * clip
        m = cfg.b1 * _load(m0) + (1 - cfg.b1) * g
        v = cfg.b2 * _load(v0) + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        p.copy_(_placed((p.float() - lr * upd).to(p.dtype), p))
        new_m[name] = _store(m, m0)
        new_v[name] = _store(v, v0)
    opt_state = {"step": step, "m": new_m, "v": new_v}
    return params, opt_state, {"grad_norm": gn, "lr": lr}


# ---- int8 error-feedback gradient compression (DP axis) --------------------

def _q8_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.float()


def _dq8_flat(q: torch.Tensor, scale: torch.Tensor, shape,
              size: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:size].reshape(shape)


def compress_grad(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 q [n/256, 256], scales [n/256, 1], new error):
    all-reduce q (cheap), correct locally with error feedback next
    step."""
    corrected = g.float() + err
    q, s = _q8_flat(corrected)
    deq = _dq8_flat(q, s, g.shape, g.numel())
    return q, s, corrected - deq


def decompress_grad(q: torch.Tensor, s: torch.Tensor, shape,
                    size: int) -> torch.Tensor:
    return _dq8_flat(q, s, shape, size)
