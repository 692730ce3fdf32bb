"""WAN network environment: per-pair delays, NIC egress serialization, and
scenario-driven adversities, as device tensors (port of
``repro.core.netsim``).

``build_env`` returns one grid point's env: a dict of fixed-shape tensors
on the requested device (no Python scalars). The sweep engine stacks the
points' envs along a leading batch axis ``B``; the per-tick accessors
(``alive``, ``link_delay``, ``link_drop``, ``nic_rate``) take that batched
env and the tick ``t``, a 0-dim int32 tensor on the env's device (a Python
int is converted), and return ``[B, ...]`` tensors. They index on the
device only, so the tick stays free of host syncs.

Adverse conditions come in as windowed tables lowered from a declarative
``repro_torch.scenarios.Scenario``: ``win_of_tick [T]`` plus per-window
``alive_tab [W, n]``, ``drop_tab [W, n, n]``, ``delay_tab [W, n, n]``
(extra ticks) and ``nic_tab [W, n]`` (egress scale).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import scenarios as sc
from repro_torch.configs.smr import SMRConfig

# extra slots past the provable static bound: absorbs rounding and the
# sub-tick serialization remainders without changing the power-of-two size
_HORIZON_MARGIN_TICKS = 16
# ring-size floor of ``resolve_horizon(..., canonical=True)``, the
# reference's: shape-compatible sweeps land on one program signature (one
# captured tick program, core/compile_cache.py). The ring's size does not
# change a result: a message lands at (t + delay) % D either way.
CANONICAL_HORIZON = 256


def sim_ticks(cfg: SMRConfig) -> int:
    """Number of simulator ticks."""
    return int(cfg.sim_seconds * 1000 / cfg.tick_ms)


def env_windows(cfg: SMRConfig, scenario) -> int:
    """Windowed-table rows this scenario lowers to: the common pad width
    to pick before stacking envs."""
    return sc.compile.n_windows(cfg, sc.as_scenario(scenario))


def _backlog_bound_ticks(cfg: SMRConfig, min_nic_scale: float) -> float:
    """Upper bound on NIC egress queueing delay (ticks). Batch formation is
    completion-gated, so at most ``mandator_lanes`` maximal batches can
    queue on one sender's NIC at once; each serializes to all n receivers
    at the (throttle-scaled) egress rate. A fully cut NIC has no finite
    bound — the caller caps the horizon at the sim length."""
    if min_nic_scale <= 0.0:
        return np.inf
    bytes_per_tick = cfg.nic_gbps * 1e9 / 8.0 * cfg.tick_ms / 1000.0
    max_batch_bytes = (max(cfg.batch_paxos, cfg.batch_mandator,
                           cfg.batch_sporades) * cfg.request_bytes + 100.0)
    outstanding = max(1, cfg.mandator_lanes)
    return outstanding * cfg.n_replicas * max_batch_bytes / (
        bytes_per_tick * float(min_nic_scale))


def resolve_horizon(cfg: SMRConfig, scenarios_=(), tabs=None,
                    canonical: bool = False) -> SMRConfig:
    """Resolve ``delay_horizon_ticks="auto"`` to the exact bound for a
    sweep: max static link delay + the largest scenario ``extra_delay`` +
    the NIC-backlog bound under the worst scenario throttle, next power of
    two, capped at one sim length (a ring spanning the run clips only
    deliveries after its end). Call it with EVERY scenario of a sweep so
    all grid points share one ring shape; pass ``tabs`` (their lowered,
    unpadded tables) to avoid re-lowering. No-op on int horizons. With
    ``canonical`` the size is floored at ``CANONICAL_HORIZON``."""
    if isinstance(cfg.delay_horizon_ticks, int):
        return cfg
    if cfg.delay_horizon_ticks != "auto":
        raise ValueError(
            f"delay_horizon_ticks must be an int or 'auto', got "
            f"{cfg.delay_horizon_ticks!r}")
    if tabs is None:
        tabs = [sc.lower(cfg, sc.as_scenario(s)) for s in scenarios_]
    extra = 0.0
    min_scale = 1.0
    for tab in tabs:
        extra = max(extra, float(np.max(tab["extra_delay"], initial=0.0)))
        min_scale = min(min_scale, float(np.min(tab["nic_scale"],
                                                initial=1.0)))
    bound = (np.max(cfg.delays_ms()) / cfg.tick_ms + extra
             + _backlog_bound_ticks(cfg, min_scale) + _HORIZON_MARGIN_TICKS)
    bound = min(float(bound), float(sim_ticks(cfg) + 1))
    horizon = max(64, 1 << max(0, int(np.ceil(bound)) - 1).bit_length())
    if canonical:
        horizon = max(horizon, CANONICAL_HORIZON)
    return dataclasses.replace(cfg, delay_horizon_ticks=int(horizon))


def build_env(cfg: SMRConfig, scenario=None, n_windows: Optional[int] = None,
              tab=None, device=None) -> Dict[str, torch.Tensor]:
    """One grid point's env as tensors on ``device`` (None = CUDA); the
    tables go to the card without waiting on it (``device.to_device``).
    scenario: a repro_torch.scenarios.Scenario or None (fault-free
    baseline). tab: its lowered (unpadded) tables, if the caller already
    has them. Leaves and dtypes equal the reference's ``build_env``."""
    dev = _device.resolve(device)
    if tab is None:
        tab = sc.lower(cfg, sc.as_scenario(scenario))
    pinned = isinstance(cfg.delay_horizon_ticks, int)
    cfg = resolve_horizon(cfg, tabs=[tab])
    if n_windows is not None:
        tab = sc.compile.pad_tables(tab, n_windows)
    # a static link + scenario delay beyond a PINNED horizon would silently
    # distort every message; an "auto" horizon only falls short of it when
    # capped at the sim length, where nothing past the end is observable
    static_delay = (np.max(cfg.delays_ms()) / cfg.tick_ms
                    + float(np.max(tab["extra_delay"], initial=0.0)))
    if static_delay >= cfg.delay_horizon_ticks and (
            pinned or cfg.delay_horizon_ticks - 1 < sim_ticks(cfg)):
        raise ValueError(
            f"link + scenario delay ({static_delay:.0f} ticks) exceeds "
            f"delay_horizon_ticks={cfg.delay_horizon_ticks}; raise the "
            "horizon in SMRConfig")
    f32 = lambda x: _device.to_device(  # noqa: E731
        np.asarray(x, np.float32), dev)
    return {
        "delays": f32(cfg.delays_ms() / cfg.tick_ms),                 # [n,n]
        "win_of_tick": _device.to_device(tab["win_of_tick"], dev),
        "alive_tab": _device.to_device(tab["alive"], dev),           # [W,n]
        "drop_tab": _device.to_device(tab["drop"], dev),           # [W,n,n]
        "delay_tab": f32(tab["extra_delay"]),                        # [W,n,n]
        "nic_tab": f32(tab["nic_scale"]),                            # [W,n]
        "bytes_per_tick": f32(cfg.nic_gbps * 1e9 / 8.0 * cfg.tick_ms
                              / 1000.0),
        "cpu_req_per_tick": f32(cfg.tick_ms * 1000.0
                                / cfg.cpu_us_per_request),
    }


def stack_envs(envs: Sequence[Dict[str, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    """Stack single-point envs leaf-wise into a batched env (leading axis =
    grid point). All envs must share cfg and ``n_windows``."""
    return {k: torch.stack([e[k] for e in envs]) for k in envs[0]}


def _win(env, t: torch.Tensor) -> torch.Tensor:
    """[B] window row of tick t, per lane."""
    wot = env["win_of_tick"]
    t = _device.tick_index(t, wot.device)
    return wot.index_select(1, t.long().view(1))[:, 0].long()


def _rows(table: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """table [B, W, ...] at row w[b] of each lane -> [B, ...]."""
    idx = w.view(-1, *([1] * (table.dim() - 1))).expand(
        -1, 1, *table.shape[2:])
    return torch.gather(table, 1, idx).squeeze(1)


def alive(env, t: torch.Tensor) -> torch.Tensor:
    """[B, n] bool — replica is up in tick t's window."""
    return _rows(env["alive_tab"], _win(env, t))


def link_delay(env, t: torch.Tensor) -> torch.Tensor:
    """[B, n, n] delay in ticks including the scenario's extra delay."""
    return env["delays"] + _rows(env["delay_tab"], _win(env, t))


def link_drop(env, t: torch.Tensor) -> torch.Tensor:
    """[B, n, n] bool — links the scenario cuts this tick."""
    return _rows(env["drop_tab"], _win(env, t))


def nic_rate(env, t: torch.Tensor) -> torch.Tensor:
    """[B, n] effective egress bytes/tick per sender (throttle-scaled)."""
    return env["bytes_per_tick"][:, None] * _rows(env["nic_tab"],
                                                  _win(env, t))


def egress_delay(busy: torch.Tensor, t: torch.Tensor,
                 bytes_out: torch.Tensor):
    """NIC serialization. busy: [B, n] abs tick when the NIC frees;
    bytes_out: [B, n, n] bytes (already divided by the NIC rate) sent this
    tick, serialized in receiver order. Returns (new_busy [B, n],
    extra_delay_ticks [B, n, n])."""
    tf = _device.tick_index(t, busy.device).float()
    cum = torch.cumsum(bytes_out, dim=2)
    start = torch.maximum(busy, tf)[:, :, None]
    finish = start + cum
    new_busy = start[:, :, 0] + cum[:, :, -1]
    return new_busy, finish - tf
