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

``dispatch_sweep`` returns a ``PendingSweep`` before the grid has run, as
the reference's does: on the card it does the host's lowering and enqueues
all the device's work (the warm-up tick, the capture when the program is
new, the replays, the metrics' extraction) and reads nothing back; only
``collect()`` waits for the card and reads the rows back, and the checks
that read a run's flags (``harness.PointResult``) raise from there.
``run_sweeps`` dispatches every request before it collects any, so each
grid's device time overlaps the host work of lowering the next. On the
CPU the grid has run by the time ``dispatch_sweep`` returns.

**Programs.** On the card a grid's tick loop is one captured tick replayed
(``harness._scan_body``, ``core/compile_cache.py``), the counterpart of the
reference's compiled sweep program. With ``canonical=True`` (the default,
as the reference's) the grid's shape axes round to the canonical program
signature: window tables pad to a power of two of at least
``CANONICAL_MIN_WINDOWS`` rows (pad rows are never indexed), the auto
horizon floors at ``netsim.CANONICAL_HORIZON``, so that sweeps of one
protocol and config with equal ``ProgramSignature``s (``_signature``)
replay one captured program. The port keeps a grid's points as the lanes
of its one program (the reference pins its program to one lane).
``capture_counts``, ``program_signatures``, ``shard_signatures`` and
``compile_report`` account for the programs, as the reference's
``trace_counts`` and friends; ``timing_stats`` splits the walls as the
reference does.

**The reduced path** (``mesh=``, the reference's sharded sweep engine):
the flattened grid's lanes split over a grid of devices
(``distributed/mesh.py``) in contiguous blocks, padded to a multiple of
the device count by repeating the last real point; each block runs
through ``harness.PointRun(..., reduced=True)`` on its device, and the
pad is sliced off the rows. The rows carry the same scalars, bit for bit,
without ``harness.REDUCED_DROPS``, plus a 64-bin latency ``sketch``. Every
block is dispatched before any is collected, as the reference's one
sharded dispatch: each device's blocks run one after another (they may
share one program's buffers), and the devices' replays are enqueued in
turns of ``REPLAY_CHUNK`` (``_interleave``), so that no device waits for
another's replays to be enqueued. One host thread does it all, so the
process-wide accounting stays exact without locks.
"""
from __future__ import annotations

import functools
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
from repro_torch.core import compile_cache, harness, netsim
from repro_torch.core import workload as wlmod
from repro_torch.core.compile_cache import ProgramSignature
from repro_torch.core.epaxos import run_epaxos_model
from repro_torch.core.rabia import run_rabia_model
from repro_torch.distributed import mesh as dmesh

ANALYTIC_PROTOCOLS = ("epaxos", "rabia")
_ANALYTIC_MODELS = {"epaxos": run_epaxos_model, "rabia": run_rabia_model}

# the window-table floor of a canonical lowering, the reference's
CANONICAL_MIN_WINDOWS = 32

# replays one block of the reduced path enqueues before the next device's
# block takes its turn
REPLAY_CHUNK = 64

_TIMING: Dict[str, Dict[str, float]] = {}
_SIGNATURES: Dict[str, set] = {}
_SHARD_SIGNATURES: Dict[str, set] = {}


def _canon_pow2(x: int, floor: int) -> int:
    """Next power of two >= x, floored at ``floor``."""
    return max(floor, 1 << (max(1, x) - 1).bit_length())


def capture_counts() -> Dict[str, int]:
    """Tick programs captured per protocol since the last reset (the
    reference's ``trace_counts``): a grid that replays a stored program
    counts 0."""
    return compile_cache.capture_counts()


def reset_capture_counts() -> None:
    """Reset the capture counters and the signature sets (the stored
    programs stay: a reused program still counts 0 captures)."""
    compile_cache.reset_stats()
    _SIGNATURES.clear()
    _SHARD_SIGNATURES.clear()


def shard_signatures() -> Dict[str, tuple]:
    """Distinct (ProgramSignature, devices) pairs dispatched through the
    reduced path per protocol since the last ``reset_capture_counts()``
    (``devices``: the mesh's device count, as the reference's)."""
    return {p: tuple(sorted(s)) for p, s in _SHARD_SIGNATURES.items()}


def program_signatures() -> Dict[str, tuple]:
    """Distinct ``ProgramSignature``s of the sweeps run per protocol since
    the last ``reset_capture_counts()``."""
    return {p: tuple(sorted(s)) for p, s in _SIGNATURES.items()}


def compile_report() -> Dict:
    """Program accounting: captures and distinct signatures per protocol
    (since the last reset) plus ``compile_cache.stats()``."""
    return {"captures": capture_counts(),
            "programs": {p: len(s) for p, s in _SIGNATURES.items()},
            "signatures": program_signatures(),
            "cache": compile_cache.stats()}


def timing_stats() -> Dict[str, Dict[str, float]]:
    """Per-protocol wall-clock of the sweeps since the last reset, in the
    reference's buckets: ``compile_s`` (the walls of dispatches that
    captured a program), ``run_s`` (the walls of the other dispatches plus
    every ``collect()``'s wait and readback), ``dispatches``, and
    ``horizon`` (the resolved ring size of the latest sweep). On the CPU a
    dispatch runs its grid, so its wall is run time."""
    return {k: dict(v) for k, v in _TIMING.items()}


def _timing(protocol: str) -> Dict[str, float]:
    return _TIMING.setdefault(protocol, {"compile_s": 0.0, "run_s": 0.0,
                                         "dispatches": 0, "horizon": 0})


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


def _lower(cfg: SMRConfig, spec: SweepSpec, device: torch.device,
           canonical: bool = False):
    """Flatten the grid to a batched env, per-lane rates (per replica per
    tick) and seeds, the workload mode (judged on the unpadded lowerings)
    and the horizon-resolved cfg. ``canonical`` pads the window tables and
    floors the horizon to the canonical program signature (module
    docstring)."""
    pts = list(spec.points())
    stabs = [sc.lower(cfg, sc.as_scenario(f)) for f in spec.scenarios]
    n_windows = max(t["alive"].shape[0] for t in stabs)
    if canonical:
        n_windows = _canon_pow2(n_windows, CANONICAL_MIN_WINDOWS)
    # build_env gets the ORIGINAL cfg, so its static-delay validation sees
    # the user's auto-vs-pinned intent; the lanes share the sweep-wide
    # resolved horizon
    envs = [netsim.build_env(cfg, f, n_windows, tab=t, device=device)
            for f, t in zip(spec.scenarios, stabs)]
    cfg = netsim.resolve_horizon(cfg, tabs=stabs, canonical=canonical)
    mode = wlc.mode_of([wlc.lower(cfg, w) for w in spec.workloads])
    env_b = netsim.stack_envs([envs[fi] for _, _, fi, _ in pts])
    # lint: allow(dtype-hygiene): per-replica Poisson rate per tick,
    # computed in float64 on the host and cast to float32, so that a
    # batched grid and a single point see identical inputs
    rate_b = (np.array([r for r, _, _, _ in pts], np.float64)
              * cfg.tick_ms / 1000.0 / cfg.n_replicas).astype(np.float32)
    seed_b = [s for _, s, _, _ in pts]
    return pts, cfg, mode, env_b, rate_b, seed_b


def _lower_workloads(cfg: SMRConfig, spec: SweepSpec,
                     canonical: bool = False) -> Dict:
    """The grid's workload tables stacked per lane (numpy), every workload
    padded to the grid's window count (``canonical``: to the canonical
    one): rate_of [B, W, n], win_of_tick [B, T], closed / think_ticks /
    cap [B]. ``win_start`` is host-side metadata of ragged width and stays
    out."""
    pad = max(wlc.compile.n_windows(cfg, w) for w in spec.workloads)
    if canonical:
        pad = _canon_pow2(pad, CANONICAL_MIN_WINDOWS)
    tabs = [wlc.lower(cfg, w, pad_windows=pad) for w in spec.workloads]
    widx = [wi for _, _, _, wi in spec.points()]
    return {k: np.stack([tabs[wi][k] for wi in widx])
            for k in tabs[0] if k != "win_start"}


def _signature_of(cfg: SMRConfig, mode, env_b: Dict, wlt: Dict, rate_b,
                  sampling: bool = True) -> ProgramSignature:
    """The ``ProgramSignature`` of a lowered sweep (``_lower`` and
    ``_lower_workloads``' results): replicas, ticks, lanes, the padded
    window rows, the resolved horizon, the workload mode and, where closed
    lanes sample an epoch stream (``sampling``: no replayed ``draws``),
    its width ``workload.epoch_slots``."""
    slots = 0
    if mode.closed and sampling:
        slots = wlmod.epoch_slots(max(
            wlmod.epoch_count(rate_b[b], wlt, b) if wlt["closed"][b] > 0
            else 0 for b in range(len(rate_b))))
    return ProgramSignature(
        n=cfg.n_replicas, ticks=netsim.sim_ticks(cfg), lanes=len(rate_b),
        scen_windows=int(env_b["alive_tab"].shape[1]),
        wl_windows=int(wlt["rate_of"].shape[1]),
        horizon=int(cfg.delay_horizon_ticks), trivial=mode.trivial,
        closed=mode.closed, epoch_slots=slots)


def _signature(cfg: SMRConfig, spec: SweepSpec, canonical: bool = True,
               sampling: bool = True) -> ProgramSignature:
    """The ``ProgramSignature`` a sweep of ``spec`` runs under, lowered on
    the CPU (the reference's ``_lower(...)[-1]``)."""
    _, rcfg, mode, env_b, rate_b, _ = _lower(cfg, spec, torch.device("cpu"),
                                             canonical)
    return _signature_of(rcfg, mode, env_b,
                         _lower_workloads(rcfg, spec, canonical), rate_b,
                         sampling)


# per-point arrays: the timelines and per-origin quantiles every scan
# protocol returns unreduced; closed-loop in-flight high water and the
# flight recorder's phase breakdown (absent at trace_level off). The
# reduced path returns none of harness.REDUCED_DROPS.
_ROW_ARRAYS = ("timeline", "origin_median_ms", "origin_p99_ms",
               "origin_timeline", "origin_lat_ms_timeline",
               "inflight_max", "phase_med_ms", "phase_p99_ms",
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


def _take(tree, idx):
    """Lanes ``idx`` (a slice or an index array) of a tree of [B, ...]
    tensors or arrays; None stays None."""
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[idx if isinstance(idx, slice)
                    else _device.to_device(idx, tree.device)]
    return None if tree is None else np.asarray(tree)[idx]


def _concat(trees):
    if isinstance(trees[0], dict):
        return {k: _concat([t[k] for t in trees]) for k in trees[0]}
    return np.concatenate(trees, axis=0)


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


def _blocks(n_real: int, n_dev: int):
    """The lane indices of each device's contiguous block: the grid padded
    to a multiple of ``n_dev`` by repeating its last point."""
    idx = np.concatenate([np.arange(n_real),
                          np.full((-n_real) % n_dev, n_real - 1)])
    return np.split(idx.astype(np.int64), n_dev)


_DONE = object()


def _interleave(starts, devices) -> List[harness.PointResult]:
    """Run the reduced path's blocks (``starts[i]()`` makes block i's
    ``harness.PointRun`` on ``devices[i]``): each device's blocks one
    after another, since they may share one program's buffers, and the
    devices' replays enqueued ``REPLAY_CHUNK`` at a time in turns, so that
    every device has work queued while the host feeds the others. Returns
    each block's results, in block order."""
    results: List = [None] * len(starts)

    def blocks_on(dev):
        for i, start in enumerate(starts):
            if devices[i] != dev:
                continue
            run = start()
            while run.advance(REPLAY_CHUNK):
                yield
            results[i] = run.finish()

    turns = [blocks_on(dev) for dev in dict.fromkeys(devices)]
    while turns:
        turns = [g for g in turns if next(g, _DONE) is not _DONE]
    return results


def _rows(protocol: str, pts, wl_names: List[str], out: Dict) -> List[Dict]:
    """One result dict per grid point from the read-back [B, ...] arrays."""
    results: List[Dict] = []
    for i, (rate, seed, fi, wi) in enumerate(pts):
        r: Dict = {"protocol": protocol, "rate": rate, "seed": seed,
                   "workload": wl_names[wi],
                   "throughput": float(out["throughput"][i]),
                   "median_ms": float(out["median_ms"][i]),
                   "p99_ms": float(out["p99_ms"][i]),
                   "committed": float(out["committed"][i])}
        for k in _ROW_ARRAYS:
            if k in out:
                r[k] = out[k][i]
        if protocol == "mandator-sporades":
            r["async_frac"] = float(out["async_frac"][i])
            r["views"] = int(out["views"][i])
            for k in ("cvc_all", "commit_key"):
                if k in out:
                    r[k] = out[k][i]
        # the reduced path's sketch, the flight recorder's rings and the
        # health monitor's gauges (absent when unreduced or off)
        for k in ("sketch", "obs", "mon"):
            if k in out:
                r[k] = _lane(out[k], i)
        results.append(r)
    return results


class PendingSweep:
    """A dispatched sweep whose device work may still be running.
    ``collect()`` waits for it, raises as the runs' checks say (before
    any row is returned), reads the results back, slices off the reduced
    path's pad and builds the rows, once: a second ``collect()`` returns
    the same list. It holds each run's ``harness.PointResult``, and so
    the captured programs they replayed, until then. Analytic protocols
    resolve at dispatch (``results``)."""

    def __init__(self, protocol: str, *, results: List[Dict] = None,
                 pts=None, wl_names=None, points=None, n_real=None):
        self.protocol = protocol
        self._results = results
        self._pts = pts
        self._wl_names = wl_names
        self._points = points     # harness.PointResult, one per block
        self._n_real = n_real     # reduced path: real points before the pad

    def collect(self) -> List[Dict]:
        if self._results is not None:
            return self._results
        t0 = time.perf_counter()
        for p in self._points:
            p.checked()
        outs = [_to_numpy(p.out) for p in self._points]
        out = outs[0] if len(outs) == 1 else _concat(outs)
        if self._n_real is not None:
            out = _take(out, slice(self._n_real))
        _timing(self.protocol)["run_s"] += time.perf_counter() - t0
        self._points = None
        self._results = _rows(self.protocol, self._pts, self._wl_names, out)
        return self._results


def _dispatch_scan(protocol: str, cfg: SMRConfig, spec: SweepSpec,
                   wl_names: List[str], device, draws, epochs, mesh=None,
                   canonical: bool = True) -> PendingSweep:
    devices = dmesh.as_grid_mesh(mesh)
    reduced = devices is not None
    if reduced and device is not None:
        raise ValueError("pass either device= or mesh=: a mesh names the "
                         "devices of the reduced path")
    if not reduced:
        devices = [_device.resolve(device)]
    t0 = time.perf_counter()
    captures = compile_cache.stats()["captures"]
    # the reduced path lowers on the host; each block goes to its device
    pts, cfg, mode, env_b, rate_b, seed_b = _lower(
        cfg, spec, torch.device("cpu") if reduced else devices[0],
        canonical)
    harness.check_supported(protocol, cfg, mode)
    wlt = _lower_workloads(cfg, spec, canonical)
    sig = _signature_of(cfg, mode, env_b, wlt, rate_b,
                        sampling=draws is None or epochs is not None)
    _SIGNATURES.setdefault(protocol, set()).add(sig)
    seed_b = np.asarray(seed_b)
    if reduced:
        _SHARD_SIGNATURES.setdefault(protocol, set()).add(
            (sig, len(devices)))
        starts = [functools.partial(
            harness.PointRun, protocol, cfg, _take(env_b, blk),
            rate_b[blk].tolist(), seed_b[blk].tolist(),
            draws=_take(draws, blk), mode=mode, device=dev,
            wlt=_take(wlt, blk), epochs=_take(epochs, blk), reduced=True)
            for dev, blk in zip(devices, _blocks(len(pts), len(devices)))]
        points = _interleave(starts, devices)
    else:
        run = harness.PointRun(protocol, cfg, env_b, rate_b.tolist(),
                               seed_b.tolist(), draws=draws, mode=mode,
                               device=devices[0], wlt=wlt, epochs=epochs)
        run.advance()
        points = [run.finish()]
    stats = _timing(protocol)
    captured = compile_cache.stats()["captures"] > captures
    stats["compile_s" if captured else "run_s"] += time.perf_counter() - t0
    stats["dispatches"] += 1
    stats["horizon"] = int(cfg.delay_horizon_ticks)
    return PendingSweep(protocol, pts=pts, wl_names=wl_names, points=points,
                        n_real=len(pts) if reduced else None)


def dispatch_sweep(protocol: str, cfg: SMRConfig, spec: SweepSpec,
                   device=None, draws=None, epochs=None, mesh=None,
                   canonical: bool = True) -> PendingSweep:
    """Lower and dispatch the grid without waiting for the device: returns
    a ``PendingSweep`` whose ``collect()`` gives the rows. Scan protocols
    (``harness.PROTOCOLS``) run as one batched dispatch of B lanes on
    ``device`` (None = CUDA, raises without one; or e.g. "cpu"), under
    any library workload and any trace or monitor level. ``draws`` (an
    optional [B, T, n] arrival table) and ``epochs`` (an optional
    [B, n, M] epoch stream of the closed lanes) replace their per-lane
    torch draws (see ``harness.sim_point``). The analytic baselines
    (``ANALYTIC_PROTOCOLS``) loop on the host, resolve here, and take
    neither.

    ``mesh`` selects the reduced path (module docstring): an int (the
    first N CUDA devices) or a sequence of devices
    (``distributed.mesh.as_grid_mesh``); ``device`` must then be None.
    Analytic protocols ignore it. ``canonical`` rounds the grid's shapes
    to the canonical program signature (module docstring); the rows do not
    depend on it."""
    wl_names = [wlc.as_workload(w).name for w in spec.workloads]
    if protocol in ANALYTIC_PROTOCOLS:
        if draws is not None or epochs is not None:
            raise ValueError(f"{protocol} is an analytic model and draws no "
                             "arrivals")
        return PendingSweep(protocol, results=_analytic_rows(
            protocol, cfg, spec, wl_names))
    return _dispatch_scan(protocol, cfg, spec, wl_names, device, draws,
                          epochs, mesh, canonical)


def run_sweep(protocol: str, cfg: SMRConfig, spec: SweepSpec, device=None,
              draws=None, epochs=None, mesh=None,
              canonical: bool = True) -> List[Dict]:
    """Run the whole grid; returns one result dict per point, in
    ``spec.points()`` order, with the keys of the reference's
    ``PendingSweep.collect`` for this protocol (its reduced keys with
    ``mesh``). See ``dispatch_sweep`` for ``device``, ``draws``,
    ``epochs``, ``mesh`` and ``canonical``."""
    return dispatch_sweep(protocol, cfg, spec, device, draws, epochs, mesh,
                          canonical).collect()


def run_sweeps(requests, device=None) -> List[List[Dict]]:
    """Dispatch every ``(protocol, cfg, spec)`` request before collecting
    any, so each grid's device time overlaps the host work of lowering the
    next; returns the per-request rows in request order, equal to
    ``[run_sweep(*r, device=device) for r in requests]``."""
    pending = [dispatch_sweep(p, cfg, spec, device=device)
               for p, cfg, spec in requests]
    return [p.collect() for p in pending]
