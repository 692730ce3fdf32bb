"""Mixture-of-Experts MLP (port of ``repro.models.moe``): top-k
token-choice routing with capacity-based grouped dispatch (dense one-hot
products, as the reference computes them), optional parallel dense
residual (arctic).

The reference's ``ep_axis`` / ``tok_axes`` only place the dispatch on a
mesh; the port runs on one device, and ``CallConfig`` refuses
``moe_ep_axis`` (ROADMAP A17.7).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def route(p: Weights, x: torch.Tensor, *, cfg: ModelConfig,
          group_size: int = 1024) -> Dict[str, torch.Tensor]:
    """The router's side of ``moe_mlp``, x: [B,S,D] in groups of
    ``min(group_size, B*S)`` tokens. Returns the router ``logits`` and
    ``probs`` [G,Sg,E], ``topi`` [G,Sg,K], the ``onehot`` [G,Sg,K,E],
    ``disp`` (0/1) and ``comb`` [G,Sg,E,C]. Routing runs in float32, or
    in float64 for float64 inputs."""
    m = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    g_sz = min(group_size, n_tok)
    if n_tok % g_sz:
        raise ValueError(f"{n_tok} tokens do not split into groups of "
                         f"{g_sz}")
    n_grp, k, e = n_tok // g_sz, m.top_k, m.n_experts
    xg = x.reshape(n_grp, g_sz, d)                           # [G, Sg, D]
    cap = _capacity(g_sz, e, k, m.capacity_factor)
    acc = torch.promote_types(x.dtype, torch.float32)

    logits = torch.einsum("gsd,de->gse", xg, p.router).to(acc)
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
    return {"logits": logits, "probs": probs, "topi": topi,
            "onehot": onehot, "disp": disp, "comb": comb}


def moe_mlp(p: Weights, x: torch.Tensor, *, cfg: ModelConfig,
            group_size: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (y [B,S,D], aux loss, a float32 scalar: the Switch
    load-balance loss plus the router z-loss). Tokens are routed in
    groups (``route``) so the dispatch one-hots stay [G, Sg, E, C]."""
    m = cfg.moe
    b, s, d = x.shape
    r = route(p, x, cfg=cfg, group_size=group_size)
    dt = x.dtype
    xg = x.reshape(r["disp"].shape[0], -1, d)
    xe = torch.einsum("gsd,gsec->gecd", xg, r["disp"].to(dt))  # [G,E,C,D]
    h = torch.einsum("gecd,edf->gecf", xe, p.w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, p.w_up)
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p.w_down)
    y = torch.einsum("gecd,gsec->gsd", ye, r["comb"].to(dt)).reshape(b, s, d)

    # aux losses: load-balance (Switch) + router z-loss
    me = r["probs"].mean(dim=(0, 1))                         # [E]
    ce = r["onehot"].sum(2).mean(dim=(0, 1))                 # fraction routed
    aux = m.aux_loss * m.n_experts * torch.sum(me * ce)
    zl = m.router_z_loss * torch.mean(
        torch.logsumexp(r["logits"], dim=-1) ** 2)
    if m.dense_residual:
        y = y + swiglu(p.dense, x)
    return y, (aux + zl).float()
