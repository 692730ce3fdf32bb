"""Batched experiment engine: a whole workload × scenario × rate × seed
sweep grid as ONE batched dispatch of B lanes (port of
``repro.core.experiment``).

``run_sweep`` lowers a ``SweepSpec`` on the host:

  1. the channel delay horizon is resolved ONCE for the whole sweep
     (``netsim.resolve_horizon`` over every scenario of the grid), so every
     lane shares one ring shape;
  2. every scenario becomes an env (``netsim.build_env``, window tables
     padded to a common width), and every workload a windowed rate table
     (``workloads.lower``, padded the same way); the flattened grid's envs
     and tables stack along a leading batch axis B;
  3. ``harness.sim_point`` runs all B lanes through one tick loop and
     extracts their metrics on the device.

Grid points are independent lanes: a lane's result does not depend on the
other lanes (its arrivals come from its own generator), so a batched grid
equals the same points run one by one, bit for bit — open-loop lanes
sharing a closed-mode grid with closed-loop lanes included.

The analytic baselines (epaxos / rabia) have no tick loop; they are looped
on the host behind the same API, and touch no device.

``dispatch_sweep`` returns a ``PendingSweep`` as the reference's does, but
runs the grid before it returns: the host loop over ticks is what drives
the device, so there is nothing left to overlap with a later dispatch.
``collect()`` only hands the rows over.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import scenarios as sc
from repro_torch import workloads as wlc
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import harness, netsim
from repro_torch.core.epaxos import run_epaxos_model
from repro_torch.core.rabia import run_rabia_model

ANALYTIC_PROTOCOLS = ("epaxos", "rabia")
_ANALYTIC_MODELS = {"epaxos": run_epaxos_model, "rabia": run_rabia_model}

_TIMING: Dict[str, Dict[str, float]] = {}


def timing_stats() -> Dict[str, Dict[str, float]]:
    """Per-protocol wall-clock of the sweeps since the last reset:
    ``run_s`` (tick loop + metrics + readback) and ``horizon`` (the
    resolved ring size of the latest sweep)."""
    return {k: dict(v) for k, v in _TIMING.items()}


def reset_timing_stats() -> None:
    _TIMING.clear()


@dataclass(frozen=True)
class SweepSpec:
    """A sweep grid: cartesian product of rates (tx/s), seeds,
    network-scenario variants and traffic-shape variants. ``points()``
    yields the flattened grid in rate-major order as (rate, seed,
    scenario_index, workload_index) — the order ``run_sweep`` returns."""
    rates: Tuple[float, ...]
    seeds: Tuple[int, ...] = (0,)
    scenarios: Tuple = (None,)
    workloads: Tuple = (None,)

    def points(self) -> Iterator[Tuple[float, int, int, int]]:
        for rate, seed, fi, wi in itertools.product(
                self.rates, self.seeds, range(len(self.scenarios)),
                range(len(self.workloads))):
            yield float(rate), int(seed), fi, wi

    @property
    def size(self) -> int:
        return (len(self.rates) * len(self.seeds) * len(self.scenarios)
                * len(self.workloads))


def _lower(cfg: SMRConfig, spec: SweepSpec, device: torch.device):
    """Flatten the grid to a batched env, per-lane rates (per replica per
    tick) and seeds, the workload mode (judged on the unpadded lowerings)
    and the horizon-resolved cfg."""
    pts = list(spec.points())
    stabs = [sc.lower(cfg, sc.as_scenario(f)) for f in spec.scenarios]
    n_windows = max(t["alive"].shape[0] for t in stabs)
    # build_env gets the ORIGINAL cfg, so its static-delay validation sees
    # the user's auto-vs-pinned intent; the lanes share the sweep-wide
    # resolved horizon
    envs = [netsim.build_env(cfg, f, n_windows, tab=t, device=device)
            for f, t in zip(spec.scenarios, stabs)]
    cfg = netsim.resolve_horizon(cfg, tabs=stabs)
    mode = wlc.mode_of([wlc.lower(cfg, w) for w in spec.workloads])
    env_b = netsim.stack_envs([envs[fi] for _, _, fi, _ in pts])
    # per-replica Poisson rate per tick, computed in float64 on the host
    # so that a batched grid and a single point see identical inputs
    rate_b = (np.array([r for r, _, _, _ in pts], np.float64)
              * cfg.tick_ms / 1000.0 / cfg.n_replicas).astype(np.float32)
    seed_b = [s for _, s, _, _ in pts]
    return pts, cfg, mode, env_b, rate_b, seed_b


def _lower_workloads(cfg: SMRConfig, spec: SweepSpec) -> Dict:
    """The grid's workload tables stacked per lane (numpy), every workload
    padded to the grid's window count: rate_of [B, W, n], win_of_tick
    [B, T], closed / think_ticks / cap [B]. ``win_start`` is host-side
    metadata of ragged width and stays out."""
    pad = max(wlc.compile.n_windows(cfg, w) for w in spec.workloads)
    tabs = [wlc.lower(cfg, w, pad_windows=pad) for w in spec.workloads]
    widx = [wi for _, _, _, wi in spec.points()]
    return {k: np.stack([tabs[wi][k] for wi in widx])
            for k in tabs[0] if k != "win_start"}


class PendingSweep:
    """A dispatched sweep. In the port the grid has already run when
    ``dispatch_sweep`` returns (see the module docstring); ``collect()``
    returns its rows."""

    def __init__(self, protocol: str, results: List[Dict]):
        self.protocol = protocol
        self._results = results

    def collect(self) -> List[Dict]:
        return self._results


# per-point metric arrays every scan protocol returns
_ROW_ARRAYS = ("timeline", "origin_median_ms", "origin_p99_ms",
               "origin_timeline", "origin_lat_ms_timeline")
# per-point arrays present in some modes only: closed-loop in-flight high
# water, the flight recorder's phase breakdown (absent at trace_level off)
_ROW_OPTIONAL = ("inflight_max", "phase_med_ms", "phase_p99_ms",
                 "phase_origin_med_ms", "phase_origin_p99_ms",
                 "batch_marks_t", "batch_arr_t", "batch_n")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def _lane(tree, i: int):
    if isinstance(tree, dict):
        return {k: _lane(v, i) for k, v in tree.items()}
    return tree[i]


def _analytic_rows(protocol: str, cfg: SMRConfig, spec: SweepSpec,
                   wl_names: List[str]) -> List[Dict]:
    model = _ANALYTIC_MODELS[protocol]
    rows = []
    for rate, seed, fi, wi in spec.points():
        r = model(cfg, rate, spec.scenarios[fi], workload=spec.workloads[wi])
        r["seed"] = seed
        r["workload"] = wl_names[wi]
        rows.append(r)
    return rows


def _scan_rows(protocol: str, cfg: SMRConfig, spec: SweepSpec,
               wl_names: List[str], device, draws, epochs) -> List[Dict]:
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    pts, cfg, mode, env_b, rate_b, seed_b = _lower(cfg, spec, dev)
    harness.check_supported(protocol, cfg, mode)
    out = harness.sim_point(protocol, cfg, env_b, rate_b.tolist(), seed_b,
                            draws=draws, mode=mode, device=dev,
                            wlt=_lower_workloads(cfg, spec), epochs=epochs)
    out = _to_numpy(out)
    stats = _TIMING.setdefault(protocol, {"run_s": 0.0, "horizon": 0})
    stats["run_s"] += time.perf_counter() - t0
    stats["horizon"] = int(cfg.delay_horizon_ticks)
    results: List[Dict] = []
    for i, (rate, seed, fi, wi) in enumerate(pts):
        r: Dict = {"protocol": protocol, "rate": rate, "seed": seed,
                   "workload": wl_names[wi],
                   "throughput": float(out["throughput"][i]),
                   "median_ms": float(out["median_ms"][i]),
                   "p99_ms": float(out["p99_ms"][i]),
                   "committed": float(out["committed"][i])}
        for k in _ROW_ARRAYS:
            r[k] = out[k][i]
        if protocol == "mandator-sporades":
            r["async_frac"] = float(out["async_frac"][i])
            r["views"] = int(out["views"][i])
            r["cvc_all"] = out["cvc_all"][i]
            r["commit_key"] = out["commit_key"][i]
        for k in _ROW_OPTIONAL:
            if k in out:
                r[k] = out[k][i]
        # the flight recorder's rings and the health monitor's gauges
        # (absent when their levels are off)
        for k in ("obs", "mon"):
            if k in out:
                r[k] = _lane(out[k], i)
        results.append(r)
    return results


def dispatch_sweep(protocol: str, cfg: SMRConfig, spec: SweepSpec,
                   device=None, draws=None, epochs=None) -> PendingSweep:
    """Run the grid and return it as a ``PendingSweep``. Scan protocols
    (``harness.PROTOCOLS``) run as one batched dispatch of B lanes on
    ``device`` (None = CUDA, raises without one; or e.g. "cpu"), under
    any library workload and any trace or monitor level. ``draws`` (an
    optional [B, T, n] arrival table) and ``epochs`` (an optional
    [B, n, M] epoch stream of the closed lanes) replace their per-lane
    torch draws (see ``harness.sim_point``). The analytic baselines
    (``ANALYTIC_PROTOCOLS``) loop on the host and take neither."""
    wl_names = [wlc.as_workload(w).name for w in spec.workloads]
    if protocol in ANALYTIC_PROTOCOLS:
        if draws is not None or epochs is not None:
            raise ValueError(f"{protocol} is an analytic model and draws no "
                             "arrivals")
        return PendingSweep(protocol,
                            _analytic_rows(protocol, cfg, spec, wl_names))
    return PendingSweep(protocol, _scan_rows(protocol, cfg, spec, wl_names,
                                             device, draws, epochs))


def run_sweep(protocol: str, cfg: SMRConfig, spec: SweepSpec, device=None,
              draws=None, epochs=None) -> List[Dict]:
    """Run the whole grid; returns one result dict per point, in
    ``spec.points()`` order, with the keys of the reference's
    ``PendingSweep.collect`` for this protocol. See ``dispatch_sweep`` for
    ``device``, ``draws`` and ``epochs``."""
    return dispatch_sweep(protocol, cfg, spec, device, draws,
                          epochs).collect()
