"""On-device consensus health monitor: invariant checks + resource gauges,
batched over the grid (port of ``repro.obs.monitor``).

The flight recorder (obs/trace.py) records what happened; this module
checks, per tick and per lane, on the device, that what happened was
correct, inside the same carry.

Gating follows ``SMRConfig.monitor_level``: at ``MonitorLevel.OFF`` (the
default) ``init_monitor`` returns None, nothing enters the carry, and the
tick runs exactly the ops of an unmonitored build. ``GAUGES`` carries only
the resource reductions; ``FULL`` adds the safety/liveness violation
counters.

What is checked, per tick (violation counters count *violating ticks*):

- ``agreement``   — the committed vector clocks of every pair of alive
                    replicas are comparable (one dominates the other).
- ``prefix``      — each replica's committed state never decreases
                    (elementwise on the committed VC, and on the monotone
                    commit key/slot).
- ``commit_once`` — the cluster-wide committed round per origin never
                    exceeds what that origin has created.
- ``view_monotone`` — per-replica views/rounds never decrease.
- ``inflight_cap`` — closed-loop clients never exceed their admission cap
                    (skipped for multipaxos, whose per-origin completion
                    split is a pro-rata estimate, not an exact count).
- ``stall``       — commit-stall watchdog: consecutive ticks where the
                    cluster is healthy (some alive replica sees a quorum
                    of alive, un-partitioned peers), work is pending, and
                    no commit lands, exceed a scenario-aware grace window
                    (``stall_grace_ticks``).

Resource gauges (all levels > off): max/mean packed-ring slot occupancy,
cumulative dropped-send counts, per-replica closed-loop inflight
high-water marks, per-origin dissemination-starvation high water (batches
formed but not yet stable), plus 500 ms-bucketed occupancy/drop timelines
that obs/export.py renders as Perfetto counter tracks.

``update`` keeps every check a tensor: it never reads a value back to the
host inside the tick. Host side: ``verdict`` folds a collected sweep row
into a plain verdict dict, ``HostMonitor`` is the twin for pure-python
drivers, and ``host_verdict`` builds the same schema for the analytic
epaxos/rabia models.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import netsim


class MonitorLevel:
    """Monitor gate. OFF leaves the monitor out entirely; GAUGES keeps
    only the resource reductions; FULL adds the invariant checks."""
    OFF = "off"
    GAUGES = "gauges"
    FULL = "full"
    ORDER = (OFF, GAUGES, FULL)

    @staticmethod
    def check(level: str) -> str:
        if level not in MonitorLevel.ORDER:
            raise ValueError(f"monitor_level {level!r}; expected one of "
                             f"{MonitorLevel.ORDER}")
        return level


MONITOR_ENV = "REPRO_MONITOR"  # benchmarks read the level from the env


def level_from_env(default: str = MonitorLevel.OFF) -> str:
    """Monitor level from ``REPRO_MONITOR`` (off/gauges/full)."""
    return MonitorLevel.check(os.environ.get(MONITOR_ENV, default))


def on(level: str) -> bool:
    return MonitorLevel.check(level) != MonitorLevel.OFF


# Violation taxonomy; declaration order is the index into ``mon["viol"]``.
VIOLATIONS = ("agreement", "prefix", "commit_once", "view_monotone",
              "inflight_cap", "stall")

# Perfetto counter-track bucket width, matching the metric timelines.
BUCKET_MS = 500.0


def n_buckets(n_ticks: int, tick_ms: float) -> int:
    return max(1, int(np.ceil(n_ticks * tick_ms / BUCKET_MS)))


@functools.lru_cache(maxsize=None)
def _bucket_table(tick_ms: float, nb: int, device: torch.device
                  ) -> torch.Tensor:
    """[L] int64 bucket of each tick t < L, from the float32 product the
    reference takes, clamped to [0, nb - 1]; L passes the tick where the
    last bucket starts, so tick t's bucket is ``table[min(t, L - 1)]``.
    Made once on the host per (tick_ms, nb, device); unbounded, since a
    captured tick graph reads it where it lies."""
    length = int(np.ceil(nb * BUCKET_MS / tick_ms)) + 2
    ticks = np.arange(length, dtype=np.float32)
    b = (ticks * np.float32(tick_ms / BUCKET_MS)).astype(np.int64)
    return _device.to_device(np.clip(b, 0, nb - 1), device)


def _bucket(t: torch.Tensor, tick_ms: float, nb: int) -> torch.Tensor:
    """[1] int64 bucket of tick t (a 0-dim tensor), looked up on the
    device."""
    table = _bucket_table(float(tick_ms), int(nb), t.device)
    return table.index_select(
        0, torch.clamp(t.long(), max=table.shape[0] - 1).view(1))


def stall_grace_ticks(cfg, env) -> torch.Tensor:
    """[B] watchdog grace window in ticks. An explicit
    ``cfg.monitor_stall_grace_ms`` pins it; otherwise it is derived per
    lane from the view timeout plus the lane's own scenario delay table —
    generous on purpose: the watchdog flags silent stalls, not slow
    commits."""
    extra = env["delay_tab"].flatten(1).amax(dim=1)          # [B] ticks
    if cfg.monitor_stall_grace_ms > 0:
        return torch.full_like(
            extra, float(np.float32(cfg.monitor_stall_grace_ms
                                    / cfg.tick_ms)))
    static_delay = float(np.max(cfg.delays_ms())) / cfg.tick_ms
    to_ticks = cfg.view_timeout_ms / cfg.tick_ms
    base = float(np.float32(4.0 * to_ticks + 8.0 * static_delay + 128.0))
    return base + 8.0 * extra


def init_monitor(cfg, n_ticks: int, views: Dict) -> Optional[Dict]:
    """Monitor carry state, or None at MonitorLevel.OFF. ``views`` is the
    t=0 projection from ``harness._monitor_views`` (leaves [B, ...]); its
    keys decide which prev-state slots exist for this protocol."""
    level = MonitorLevel.check(cfg.monitor_level)
    if level == MonitorLevel.OFF:
        return None
    n = cfg.n_replicas
    nb = n_buckets(n_ticks, cfg.tick_ms)
    ref = views["formed"]
    B, dev = ref.shape[0], ref.device
    zf = lambda *s: torch.zeros((B, *s), dtype=torch.float32,  # noqa: E731
                                device=dev)
    zi = lambda *s: torch.zeros((B, *s), dtype=torch.int32,  # noqa: E731
                                device=dev)
    mon: Dict[str, torch.Tensor] = {
        "ring_occ_max": zf(),
        "ring_occ_sum": zf(),
        "dropped_sends": zi(n),
        "inflight_hwm": zf(n),
        "starved_max": zi(n),
        "occ_tl": zf(nb),
        "drop_tl": zf(nb),
    }
    if level == MonitorLevel.FULL:
        mon["viol"] = zi(len(VIOLATIONS))
        mon["stall_run"] = zi()
        mon["stall_max"] = zi()
        prev: Dict[str, torch.Tensor] = {
            "commit_tot": views["commit_tot"].float()}
        for k in ("cvc", "commit_seq", "view"):
            if views.get(k) is not None:
                prev[k] = views[k]
        mon["prev"] = prev
    return mon


def _any(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] bool -> [B]."""
    return x.flatten(1).any(dim=1)


def update(mon: Optional[Dict], t: torch.Tensor, cfg, env, views: Dict,
           grace_ticks: torch.Tensor, wlt: Optional[Dict] = None,
           inflight: Optional[torch.Tensor] = None,
           check_cap: bool = False) -> Optional[Dict]:
    """One monitor tick of every lane. ``views`` is the protocol-state
    projection built by ``harness._monitor_views``; ``wlt`` the grid's
    workload tables (leaves [B, ...]); ``inflight`` [B, n]. None monitor
    state (level off) passes straight through. ``t``: the tick, a 0-dim
    int32 tensor (a Python int is converted)."""
    if mon is None:
        return None
    mon = dict(mon)
    t = _device.tick_index(t, mon["occ_tl"].device)
    # ---- resource gauges (all levels > off) -----------------------------
    occ = views["ring_occ"]                                   # [B]
    dropped = views["dropped"]                                # [B, n]
    mon["ring_occ_max"] = torch.maximum(mon["ring_occ_max"], occ)
    mon["ring_occ_sum"] = mon["ring_occ_sum"] + occ
    mon["dropped_sends"] = mon["dropped_sends"] + dropped
    b = _bucket(t, cfg.tick_ms, mon["occ_tl"].shape[1])
    occ_tl, drop_tl = mon["occ_tl"].clone(), mon["drop_tl"].clone()
    occ_tl.index_copy_(1, b, torch.maximum(occ_tl.index_select(1, b),
                                           occ[:, None]))
    drop_tl.index_copy_(1, b, drop_tl.index_select(1, b)
                        + dropped.sum(dim=1).float()[:, None])
    mon["occ_tl"], mon["drop_tl"] = occ_tl, drop_tl
    mon["starved_max"] = torch.maximum(
        mon["starved_max"], (views["formed"] - views["stable"]).int())
    if inflight is not None:
        mon["inflight_hwm"] = torch.maximum(mon["inflight_hwm"],
                                            inflight.float())
    if "viol" not in mon:
        return mon
    # ---- safety invariants ----------------------------------------------
    alive = netsim.alive(env, t)                              # [B, n]
    prev = dict(mon["prev"])
    bad: Dict[str, torch.Tensor] = {}
    cvc = views.get("cvc")
    if cvc is not None:
        # agreement: committed VCs of alive pairs must be comparable —
        # one replica's committed prefix dominates the other's.
        ge = (cvc[:, :, None, :] >= cvc[:, None, :, :]).all(dim=-1)
        both = alive[:, :, None] & alive[:, None, :]
        bad["agreement"] = _any(both & ~(ge | ge.transpose(1, 2)))
        bad["prefix"] = _any(cvc < prev["cvc"])
        prev["cvc"] = cvc
    seq = views.get("commit_seq")
    if seq is not None:
        dec = _any(seq < prev["commit_seq"])
        bad["prefix"] = bad["prefix"] | dec if "prefix" in bad else dec
        prev["commit_seq"] = seq
    # commit-once / no phantom commit: the cluster-max committed round per
    # origin never exceeds what that origin has formed.
    claim = cvc.amax(dim=1) if cvc is not None else views["stable"]
    bad["commit_once"] = _any(claim > views["formed"])
    view = views.get("view")
    if view is not None:
        bad["view_monotone"] = _any(view < prev["view"])
        prev["view"] = view
    if check_cap and inflight is not None and wlt is not None:
        over = inflight.float() > wlt["cap"][:, None].float() + 0.5
        bad["inflight_cap"] = _any(over & (wlt["closed"] > 0)[:, None])
    # ---- liveness: commit-stall watchdog --------------------------------
    commit_tot = views["commit_tot"].float()
    progress = commit_tot > prev["commit_tot"]
    prev["commit_tot"] = commit_tot
    drop = netsim.link_drop(env, t)
    conn = (alive[:, :, None] & alive[:, None, :] & ~drop
            & ~drop.transpose(1, 2))
    n = alive.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=alive.device)
    conn = conn | (eye & alive[:, :, None])
    degree = conn.sum(dim=2)
    quorum = cfg.n_replicas // 2 + 1
    healthy = (degree >= quorum).any(dim=1)
    armed = healthy & views["pending"] & ~progress
    run = torch.where(armed, mon["stall_run"] + 1, 0)
    bad["stall"] = run.float() > grace_ticks
    mon["stall_run"] = run
    mon["stall_max"] = torch.maximum(mon["stall_max"], run)
    false = torch.zeros_like(armed)
    mon["viol"] = mon["viol"] + torch.stack(
        [bad.get(name, false) for name in VIOLATIONS], dim=1).int()
    mon["prev"] = prev
    return mon


def public_view(mon: Optional[Dict], n_ticks: int) -> Optional[Dict]:
    """The monitor leaves worth surfacing out of the tick loop (everything
    but the prev-state scratch), with the running occupancy sum folded
    into a mean: times the float32 reciprocal of the tick count, as
    XLA-CPU takes the reference's division by that constant."""
    if mon is None:
        return None
    out = {k: v for k, v in mon.items() if k not in ("prev", "stall_run")}
    occ_sum = out.pop("ring_occ_sum")
    out["ring_occ_mean"] = occ_sum * torch.full_like(
        occ_sum, float(np.float32(1.0) / np.float32(max(n_ticks, 1))))
    return out


# --------------------------------------------------------------------------
# Host side: verdicts
# --------------------------------------------------------------------------

def host_verdict(violations: Optional[Dict[str, int]] = None,
                 gauges: Optional[Dict] = None,
                 level: str = MonitorLevel.FULL) -> Dict:
    """The verdict schema, from plain host-side counts (the analytic
    epaxos/rabia models build these directly)."""
    viol = {k: int(v) for k, v in (violations or {}).items() if int(v)}
    return {"ok": not viol, "violations": viol,
            "gauges": dict(gauges or {}), "level": level}


def verdict(result: Dict) -> Optional[Dict]:
    """Fold one collected sweep row into a verdict dict
    ``{"ok", "violations", "gauges", "level"}`` — or None when the point
    was produced with the monitor off. Accepts both scan rows (a ``"mon"``
    subtree of arrays) and analytic rows (a ready-made ``"monitor"``
    dict)."""
    if "monitor" in result:
        return result["monitor"]
    mon = result.get("mon")
    if mon is None:
        return None
    viol: Dict[str, int] = {}
    level = MonitorLevel.GAUGES
    if "viol" in mon:
        level = MonitorLevel.FULL
        counts = np.asarray(mon["viol"])
        viol = {name: int(counts[i]) for i, name in enumerate(VIOLATIONS)
                if counts[i]}
    gauges = {
        "ring_occ_max": float(mon["ring_occ_max"]),
        "ring_occ_mean": float(mon["ring_occ_mean"]),
        "dropped_sends": int(np.sum(np.asarray(mon["dropped_sends"]))),
        "inflight_hwm": [round(float(x), 3)
                         for x in np.asarray(mon["inflight_hwm"])],
        "starved_max": [int(x) for x in np.asarray(mon["starved_max"])],
    }
    if "stall_max" in mon:
        gauges["stall_max_ticks"] = int(mon["stall_max"])
    return {"ok": not viol, "violations": viol, "gauges": gauges,
            "level": level}


def merge_verdicts(verdicts: List[Optional[Dict]]) -> Optional[Dict]:
    """Suite-level aggregate over per-point verdicts (None entries are
    skipped)."""
    vs = [v for v in verdicts if v]
    if not vs:
        return None
    viol: Dict[str, int] = {}
    for v in vs:
        for k, c in v.get("violations", {}).items():
            viol[k] = viol.get(k, 0) + int(c)
    return {"ok": not viol, "violations": viol, "points": len(vs),
            "level": vs[0].get("level", MonitorLevel.FULL)}


def format_verdict(v: Optional[Dict]) -> str:
    """One-line rendering for summary lines."""
    if v is None:
        return "monitor off"
    if v.get("ok"):
        pts = v.get("points")
        return f"monitor OK ({pts} pts)" if pts else "monitor OK"
    parts = " ".join(f"{k}={c}" for k, c in sorted(
        v.get("violations", {}).items()))
    return f"monitor VIOLATIONS: {parts}"


def health_table(result: Dict) -> str:
    """Verdict + per-replica gauge table for one sweep row."""
    v = verdict(result)
    if v is None:
        return ("(no health data: run with monitor_level='gauges' or "
                "'full')")
    lines = [f"health: {format_verdict(v)}  [level={v.get('level')}]"]
    g = v.get("gauges", {})
    scalars = {k: val for k, val in g.items()
               if not isinstance(val, (list, tuple))}
    if scalars:
        lines.append("  " + "  ".join(
            f"{k}={val:.4g}" if isinstance(val, float) else f"{k}={val}"
            for k, val in sorted(scalars.items())))
    vectors = {k: val for k, val in g.items()
               if isinstance(val, (list, tuple))}
    if vectors:
        n = max(len(val) for val in vectors.values())
        head = "  {:<16}".format("replica") + "".join(
            f"{i:>10}" for i in range(n))
        lines.append(head)
        for k, val in sorted(vectors.items()):
            lines.append("  {:<16}".format(k) + "".join(
                f"{x:>10.3g}" if isinstance(x, float) else f"{x:>10}"
                for x in val))
    return "\n".join(lines)


def check_cvc_trace(cvc: np.ndarray,
                    alive: Optional[np.ndarray] = None) -> Dict[str, int]:
    """Host-side re-check of a committed-VC trace ``[T, n, n]`` (the
    sporades ``cvc_all`` output): counts ticks violating agreement
    (pairwise comparability of alive replicas' committed rows) and prefix
    monotonicity."""
    cvc = np.asarray(cvc)
    T, n, _ = cvc.shape
    if alive is None:
        alive = np.ones((T, n), bool)
    out = {"agreement": 0, "prefix": 0}
    ge = np.all(cvc[:, :, None, :] >= cvc[:, None, :, :], axis=-1)
    both = alive[:, :, None] & alive[:, None, :]
    out["agreement"] = int(np.sum(np.any(both & ~(ge | np.swapaxes(
        ge, 1, 2)), axis=(1, 2))))
    out["prefix"] = int(np.sum(np.any(cvc[1:] < cvc[:-1], axis=(1, 2))))
    return out


class HostMonitor:
    """Host-side twin of the device monitor for pure-python drivers: the
    same invariant taxonomy over explicit commit/completion observations
    instead of scanned state."""

    def __init__(self, n: int):
        self.n = n
        self.violations: Dict[str, int] = {}
        self._view = np.full((n,), -1, np.int64)       # last (view) seen
        self._cut: List[Optional[np.ndarray]] = [None] * n
        self._slot: Dict[tuple, np.ndarray] = {}       # (view, round) -> cut
        self._done = np.zeros((n,), np.int64)          # completion rounds

    def _flag(self, name: str) -> None:
        assert name in VIOLATIONS, name
        self.violations[name] = self.violations.get(name, 0) + 1

    def observe_commit(self, who: int, view: int, rnd: int, cut) -> None:
        """One actor commits ``cut`` (a length-n committed vector) at
        (view, round)."""
        cut = np.asarray(cut)
        if view < self._view[who]:
            self._flag("view_monotone")
        self._view[who] = max(self._view[who], view)
        prev = self._cut[who]
        if prev is not None and np.any(cut < prev):
            self._flag("prefix")
        key = (int(view), int(rnd))
        if key in self._slot:
            if not np.array_equal(self._slot[key], cut):
                self._flag("commit_once")
        else:
            self._slot[key] = cut.copy()
        for other, oc in enumerate(self._cut):
            if other == who or oc is None:
                continue
            if not (np.all(cut >= oc) or np.all(cut <= oc)):
                self._flag("agreement")
        self._cut[who] = np.maximum(cut, prev) if prev is not None else cut

    def observe_completion(self, who: int, rnd: int) -> None:
        """One dissemination pod completes round ``rnd``: completions are
        strictly in round order and never repeat."""
        last = int(self._done[who])
        if rnd <= last:
            self._flag("commit_once")
        elif rnd != last + 1:
            self._flag("prefix")
        self._done[who] = max(last, rnd)

    def verdict(self) -> Dict:
        return host_verdict(self.violations,
                            gauges={"commits": len(self._slot),
                                    "completions": int(self._done.sum())})
