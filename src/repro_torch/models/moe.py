"""Mixture-of-Experts MLP (port of ``repro.models.moe``): top-k
token-choice routing with capacity-based grouped dispatch (dense one-hot
products, as the reference computes them), optional parallel dense
residual (arctic).

Under a mesh (DTensor activations) routing stays token-local: each device
routes its own groups through ``local_map``. ``ep_axis`` switches on
explicit expert parallelism over that mesh axis, as the reference's
sharding constraints do: the dispatched tokens ``xe`` [G, E, C, D] are
redistributed from group-sharded (over ``tok_axes``) to expert-sharded
(over ``ep_axis``), the EP all-to-all, and the experts' outputs back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _dispatch
from repro_torch.models.layers import Weights, init_mlp, normal, swiglu


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Weights:
    """The reference's shapes and scales (``moe.py:19-31``): router
    [d, E], w_gate/w_up [E, d, f] ~ N(0, 1/d), w_down [E, f, d] ~
    N(0, 1/f); with ``dense_residual`` a SwiGLU MLP of ``dense_d_ff``
    (``dense``). The values are the port's own draws."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = Weights(router=normal(gen, (d, e), d ** -0.5, dtype, device),
                w_gate=normal(gen, (e, d, f), d ** -0.5, dtype, device),
                w_up=normal(gen, (e, d, f), d ** -0.5, dtype, device),
                w_down=normal(gen, (e, f, d), f ** -0.5, dtype, device))
    if m.dense_residual:
        p.dense = init_mlp(cfg, gen, m.dense_d_ff, dtype, device)
    return p


def _capacity(group_size: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(group_size * top_k / n_experts * factor)
    return max(4, -(-c // 4) * 4)      # round up to multiple of 4


ROUTE_KEYS = ("logits", "probs", "topi", "onehot", "disp", "comb")


def route(p: Weights, x: torch.Tensor, *, cfg: ModelConfig,
          group_size: int = 1024) -> Dict[str, torch.Tensor]:
    """The router's side of ``moe_mlp``, x: [B,S,D] in groups of
    ``min(group_size, B*S)`` tokens. Returns the router ``logits`` and
    ``probs`` [G,Sg,E], ``topi`` [G,Sg,K], the ``onehot`` [G,Sg,K,E],
    ``disp`` (0/1) and ``comb`` [G,Sg,E,C]. Routing runs in float32, or
    in float64 for float64 inputs. A DTensor x is routed group by group
    on the device that holds the group (the groups' dim keeps x's batch
    shards; any other placement is gathered first)."""
    b, s, d = x.shape
    n_tok = b * s
    g_sz = min(group_size, n_tok)
    if n_tok % g_sz:
        raise ValueError(f"{n_tok} tokens do not split into groups of "
                         f"{g_sz}")
    xg = x.reshape(n_tok // g_sz, g_sz, d)                   # [G, Sg, D]
    if not _dispatch.is_dtensor(xg):
        return dict(zip(ROUTE_KEYS, _route_groups(p.router, xg, cfg)))
    from torch.distributed.tensor import Replicate
    pl = _group_placements(xg)
    out = _dispatch.local_call(
        lambda w, xg: _route_groups(w, xg, cfg), (p.router, xg),
        ((Replicate(),) * len(pl), pl), (pl,) * len(ROUTE_KEYS))
    return dict(zip(ROUTE_KEYS, out))


def _route_groups(router: torch.Tensor, xg: torch.Tensor,
                  cfg: ModelConfig) -> tuple:
    """``route``'s tensors (in ``ROUTE_KEYS`` order) for xg [G, Sg, D]."""
    m = cfg.moe
    n_grp, g_sz, _ = xg.shape
    k, e = m.top_k, m.n_experts
    cap = _capacity(g_sz, e, k, m.capacity_factor)
    acc = torch.promote_types(xg.dtype, torch.float32)

    logits = torch.einsum("gsd,de->gse", xg, router).to(acc)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)   # [G,Sg,K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # position-in-expert via cumsum over (slot-major) one-hots
    onehot = F.one_hot(topi, e).to(acc)                      # [G,Sg,K,E]
    # (token, k) slots in priority order: k-major so top-1 wins capacity
    slots = onehot.permute(0, 2, 1, 3).reshape(n_grp, k * g_sz, e)
    pos_in_e = torch.cumsum(slots, dim=1) - slots            # [G, K*Sg, E]
    pos_in_e = pos_in_e.reshape(n_grp, k, g_sz, e).permute(0, 2, 1, 3)
    keep = onehot * (pos_in_e < cap)                         # [G,Sg,K,E]
    pos = (pos_in_e * keep).sum(-1)                          # slot index
    cap_oh = F.one_hot(pos.long(), cap).to(acc) \
        * keep.sum(-1, keepdim=True)                         # [G,Sg,K,C]
    disp = torch.einsum("gske,gskc->gsec", keep, cap_oh)     # [G,Sg,E,C]
    comb = torch.einsum("gske,gskc,gsk->gsec", keep, cap_oh, topv)
    return logits, probs, topi, onehot, disp, comb


def _dispatch_tokens(xg: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    return torch.einsum("gsd,gsec->gecd", xg, disp)


def _ffn(xe, w_gate, w_up, w_down):
    h = torch.einsum("gecd,edf->gecf", xe, w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down)


def _group_placements(t: torch.Tensor) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(_dispatch.even_shards(t, [
        q if _dispatch.shard_dim(q) == 0 else Replicate()
        for q in t.placements]))


def _local_groups(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fn(a, b) for two [G, ...] tensors, group by group: a DTensor a keeps
    its group shards and anything else of both is gathered."""
    if not _dispatch.is_dtensor(a):
        return fn(a, b)
    pl = _group_placements(a)
    return _dispatch.local_call(fn, (a, b), (pl, pl), pl)


def _experts(xe, w_gate, w_up, w_down):
    """The experts' SwiGLU on the dispatched tokens xe [G, E, C, D]. Under
    a mesh, mesh dim by mesh dim: tokens sharded on E run against the
    weights' matching expert shards; tokens sharded on G run against
    weights gathered on that mesh dim (FSDP's gather); otherwise, where
    the weights are expert-sharded, each device takes its experts'
    tokens (a local slice of xe); else both are gathered."""
    if not _dispatch.is_dtensor(xe):
        return _ffn(xe, w_gate, w_up, w_down)
    from torch.distributed.tensor import Replicate, Shard
    mesh, n_e = xe.device_mesh, xe.shape[1]
    x_pl, w_pl = [], []
    for m, (px, pw) in enumerate(zip(xe.placements, w_gate.placements)):
        even_e = n_e % mesh.size(m) == 0
        if _dispatch.shard_dim(px) == 1 and even_e:
            x_pl.append(Shard(1)), w_pl.append(Shard(0))
        elif _dispatch.shard_dim(px) == 0:
            x_pl.append(Shard(0)), w_pl.append(Replicate())
        elif _dispatch.shard_dim(pw) == 0 and even_e:
            x_pl.append(Shard(1)), w_pl.append(Shard(0))
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate())
    x_pl = tuple(_dispatch.even_shards(xe, x_pl))
    w_pl = tuple(w if _dispatch.shard_dim(x) is not None else Replicate()
                 for x, w in zip(x_pl, w_pl))
    return _dispatch.local_call(_ffn, (xe, w_gate, w_up, w_down),
                                (x_pl, w_pl, w_pl, w_pl), x_pl)


def _combine(ye: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """y [G, Sg, D] from the experts' outputs ye [G, E, C, D] and the
    combine weights [G, Sg, E, C]. Under a mesh, mesh dim by mesh dim:
    group shards stay local; expert shards sum their own experts' share
    (the result a pending sum over them); anything else is gathered."""
    if not _dispatch.is_dtensor(ye):
        return torch.einsum("gecd,gsec->gsd", ye, comb)
    from torch.distributed.tensor import Partial, Replicate, Shard
    y_pl, c_pl, o_pl = [], [], []
    for q in _dispatch.even_shards(ye, [
            q if _dispatch.shard_dim(q) in (0, 1) else Replicate()
            for q in ye.placements]):
        if _dispatch.shard_dim(q) == 0:
            y_pl.append(q), c_pl.append(Shard(0)), o_pl.append(Shard(0))
        elif _dispatch.shard_dim(q) == 1:
            y_pl.append(q), c_pl.append(Shard(2)), o_pl.append(Partial())
        else:
            y_pl.append(q), c_pl.append(q), o_pl.append(q)
    return _dispatch.local_call(
        lambda ye, comb: torch.einsum("gecd,gsec->gsd", ye, comb),
        (ye, comb), (tuple(y_pl), tuple(c_pl)), tuple(o_pl))


def _reshard(t: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The reference's sharding constraint on a DTensor (a plain tensor
    passes through)."""
    if not _dispatch.is_dtensor(t):
        return t
    from repro_torch.distributed.sharding import placements
    return t.redistribute(t.device_mesh, placements(spec, t.device_mesh))


def moe_mlp(p: Weights, x: torch.Tensor, *, cfg: ModelConfig,
            group_size: int = 1024, ep_axis: Optional[str] = None,
            tok_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (y [B,S,D], aux loss, a float32 scalar: the Switch
    load-balance loss plus the router z-loss). Tokens are routed in
    groups (``route``) so the dispatch one-hots stay [G, Sg, E, C]. With
    ``ep_axis`` (DTensor x) the experts run expert-sharded over that mesh
    axis between two all-to-alls."""
    m = cfg.moe
    b, s, d = x.shape
    r = route(p, x, cfg=cfg, group_size=group_size)
    dt = x.dtype
    xg = x.reshape(r["disp"].shape[0], -1, d)
    xe = _local_groups(_dispatch_tokens, xg, r["disp"].to(dt))  # [G,E,C,D]
    if ep_axis is not None:
        # 1) dispatch stays token-local (groups sharded over tok_axes)
        xe = _reshard(xe, (tuple(tok_axes) or None, None, None, None))
        # 2) g-sharded -> e-sharded: the EP all-to-all
        xe = _reshard(xe, (None, ep_axis, None, None))
    ye = _experts(xe, p.w_gate, p.w_up, p.w_down)
    if ep_axis is not None:
        ye = _reshard(ye, (None, ep_axis, None, None))
        # the return all-to-all before the token-local combine
        ye = _reshard(ye, (tuple(tok_axes) or None, None, None, None))
    y = _combine(ye, r["comb"].to(dt)).reshape(b, s, d)

    # aux losses: load-balance (Switch) + router z-loss
    me = r["probs"].mean(dim=(0, 1))                         # [E]
    ce = r["onehot"].sum(2).mean(dim=(0, 1))                 # fraction routed
    aux = m.aux_loss * m.n_experts * _dispatch.settled(torch.sum(me * ce))
    zl = m.router_z_loss * _dispatch.settled(torch.mean(
        torch.logsumexp(r["logits"], dim=-1) ** 2))
    if m.dense_residual:
        y = y + swiglu(p.dense, x)
    return y, (aux + zl).float()
