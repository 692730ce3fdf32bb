"""SMR simulation harness: drives a protocol over the WAN sim and produces
the paper's metrics (throughput, median/p99 execution latency, timelines).
Port of ``repro.core.harness`` for the scan protocols:

  mandator-sporades  — Alg 1 + Algs 2/3 (full tick-level state machines)
  mandator-paxos     — Alg 1 + Multi-Paxos ordering the vector clock
  multipaxos         — monolithic Multi-Paxos (batches inside consensus)
  mandator           — dissemination layer alone (completion throughput)

The analytic baselines (epaxos, rabia) have no tick loop; the sweep engine
(core/experiment.py) runs them on the host.

``sim_point`` runs the tick loop for every lane of a batched env at once —
per-tick outputs land in preallocated ``[B, T, ...]`` tensors — then
extracts the metrics on the device (searchsorted commit reconstruction,
weighted quantiles, timelines). The tick index ``t`` is a 0-dim int32
tensor on the run's device, advanced in place at each tick's end; no op
of a tick reads it back. On the CPU the loop is a Python loop over ticks.
On the card it is one captured tick replayed (``_scan_body``,
``core/compile_cache.py``): tick 0 runs eagerly as the warm-up, one tick
is captured as a CUDA graph — protocol ticks, monitor, trace writes and
``t += 1`` — and the graph replays for ticks 1 .. n-1. A capture or a
replay that fails raises; nothing falls back to the eager loop, which
the card runs only inside ``_eager_on_card()`` (the graph's parity
checks). Every
workload mode runs: the §5.2 baseline, windowed rate tables and closed
loops (whose in-flight feedback, ``_closed_feedback``, runs after the
protocol ticks); so does every ``trace_level`` (the layers' flight
recorders, ``_phase_breakdown``) and ``monitor_level`` (the health
monitor, fed by ``_monitor_views``). Recording and monitoring only read
the protocol state, so the metrics do not depend on either level.

``sim_point(..., reduced=True)`` is the reduced sweep path's metric
contract (``experiment.run_sweep(..., mesh=...)``): the scalars keep the
unreduced run's operations, so they are bitwise equal to it; the
per-batch and per-tick arrays of ``REDUCED_DROPS`` are neither recorded
nor computed, and a 64-bin latency ``sketch`` (``distributed/sketch.py``)
takes their place.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import compile_cache
from repro_torch.core import mandator, netsim, paxos, spans, sporades
from repro_torch.core import workload as wlmod
from repro_torch.distributed import sketch as dsketch
from repro_torch.obs import monitor as hmon
from repro_torch.obs import trace as obs
from repro_torch.workloads.compile import TRIVIAL_MODE, WorkloadMode

PROTOCOLS = ("mandator-sporades", "mandator-paxos", "multipaxos",
             "mandator")
SCAN_PROTOCOLS = PROTOCOLS          # the reference's name of the tuple
# the protocols with an ordering layer, Sporades or Paxos (``tick.order``)
ORDERING = ("mandator-sporades", "mandator-paxos", "multipaxos")

# Per-batch / per-tick output arrays whose size scales with the grid's
# record capacity: the reduced sweep path (experiment.py, ``mesh=``)
# trades them for the O(SKETCH_BINS) latency sketch. Scalar metrics are
# untouched: ``reduced`` computes them with the same operations.
REDUCED_DROPS = ("timeline", "origin_median_ms", "origin_p99_ms",
                 "origin_timeline", "origin_lat_ms_timeline",
                 "cvc_all", "commit_key",
                 "batch_marks_t", "batch_arr_t", "batch_n")
# A lane's in-window weight must stay below this for the sketch's running
# sums to be exact in float32 on every device (distributed/sketch.py)
SKETCH_EXACT_WEIGHT = 2 ** 24


def check_supported(protocol: str, cfg: SMRConfig,
                    mode: WorkloadMode = TRIVIAL_MODE) -> None:
    """Raise ValueError for a name that is no scan protocol, a trace or
    monitor level that does not exist, or a mode no grid lowers to
    (``workloads.mode_of``: a closed grid is never trivial). Every mode a
    grid lowers to runs."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"{protocol!r} is not a scan protocol; the "
                         f"harness runs {PROTOCOLS}")
    obs.TraceLevel.check(cfg.trace_level)
    hmon.MonitorLevel.check(cfg.monitor_level)
    if mode.trivial and mode.closed:
        raise ValueError(f"{mode}: a closed-loop grid is never trivial")


def init_carry(cfg: SMRConfig, n_ticks: int, batch: int,
               device: torch.device,
               protocol: str = "mandator-sporades", closed: bool = False
               ) -> Dict:
    """The carry of ``protocol``: {"m": mandator state} for the protocols
    built on Mandator, plus "s" (sporades) or "p" (paxos in mandator
    mode); {"p": paxos state} for multipaxos. ``closed`` shapes the
    workload state where the clients' requests arrive. The health
    monitor's state ("mon") is added by ``_scan_body``."""
    carry = {}
    if protocol != "multipaxos":
        carry["m"] = mandator.init_state(cfg, n_ticks, batch, device,
                                         closed)
    if protocol == "mandator-sporades":
        carry["s"] = sporades.init_state(cfg, n_ticks, batch, device)
    elif protocol in ("mandator-paxos", "multipaxos"):
        carry["p"] = paxos.init_state(
            cfg, n_ticks, protocol == "mandator-paxos", batch, device,
            closed)
    return carry


def _sum_origins(x: torch.Tensor) -> torch.Tensor:
    """[B, n] -> [B]: a float32 sum over origins in origin order, one
    rounding per add, as XLA's CPU reduction loop adds."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def _closed_feedback(protocol: str, carry: Dict):
    """Closed-loop commit feedback: a request is in flight from its
    submission until the batch carrying it commits. ``cl_done`` is the
    cumulative per-origin committed request count, recovered from the
    batch records' prefix sums at the protocol's committed rounds (both
    monotone). Returns (carry, in-flight [B, n])."""
    wl_key = "p" if protocol == "multipaxos" else "m"
    carry = dict(carry)
    part = dict(carry[wl_key])
    wl = dict(part["wl"])
    if protocol == "mandator":
        cvc_o = carry["m"]["own_round"]
    elif protocol == "mandator-sporades":
        cvc_o = carry["s"]["cvc"].amax(dim=1)
    elif protocol == "mandator-paxos":
        cvc_o = carry["p"]["cvc"].amax(dim=1)
    else:
        cvc_o = carry["p"]["committed_slot"]
    # cumulative committed count = the prefix sum at the committed round
    cum = wl["batch_count_cum"]
    idx = torch.clamp(cvc_o, 0, cum.shape[2] - 1).long()[..., None]
    done = torch.gather(cum, 2, idx)[..., 0]
    sub = wl["cl_submitted"]
    if protocol == "multipaxos":
        # batch rows live at the (rotating) leader, not the submitting
        # origin: apportion the global committed total pro rata by
        # cumulative submissions (an estimate, so no per-origin ratchet)
        share = sub / torch.clamp(_sum_origins(sub), min=1.0)[:, None]
        done = _sum_origins(done)[:, None] * share
        wl["cl_done"] = torch.minimum(torch.clamp(done, min=0.0), sub)
    else:
        wl["cl_done"] = torch.minimum(
            torch.clamp(torch.maximum(wl["cl_done"], done), min=0.0), sub)
    part["wl"] = wl
    carry[wl_key] = part
    return carry, sub - wl["cl_done"]


def _monitor_views(protocol: str, cfg: SMRConfig, carry: Dict) -> Dict:
    """Protocol-state projection the health monitor consumes
    (``obs.monitor.update``), leaves [B, ...]: per-replica committed
    vector clocks / monotone commit keys / views where the protocol has
    them (None leaves out the check), per-origin formed vs stable rounds,
    a cluster commit total, a pending-work flag, packed-ring occupancy,
    and the per-tick dropped-send counts the ticks stash in ``mon_io``."""
    n = cfg.n_replicas
    views: Dict = {"cvc": None, "commit_seq": None, "view": None}
    rings = []
    dropped = []
    if protocol in ("mandator-sporades", "mandator-paxos", "mandator"):
        m = carry["m"]
        rings.append((mandator.ring_spec(), m["ring"]))
        dropped.append(m["mon_io"]["dropped"])
        views["formed"] = m["formed_round"]
        views["stable"] = m["own_round"]
        pending = (m["wl"]["buffer"] > 0).any(dim=1)
    if protocol == "mandator":
        # lcr rows are per-replica knowledge vectors: no agreement check;
        # completion order still is one
        views["commit_seq"] = m["own_round"]
        views["commit_tot"] = m["own_round"].sum(dim=1).float()
        views["pending"] = pending | (m["formed_round"]
                                      > m["own_round"]).any(dim=1)
    elif protocol == "mandator-sporades":
        s = carry["s"]
        rings.append((sporades.ring_spec(n), s["ring"]))
        dropped.append(s["mon_io"]["dropped"])
        views["cvc"] = s["cvc"]
        views["commit_seq"] = s["commit_key"]
        views["view"] = s["v_cur"]
        views["commit_tot"] = s["cvc"].flatten(1).sum(dim=1).float()
        views["pending"] = pending | (m["formed_round"]
                                      > s["cvc"].amax(dim=1)).any(dim=1)
    elif protocol == "mandator-paxos":
        p = carry["p"]
        rings.append((paxos.ring_spec(n, True), p["ring"]))
        dropped.append(p["mon_io"]["dropped"])
        views["cvc"] = p["cvc"]
        views["view"] = p["view"]
        views["commit_tot"] = p["cvc"].flatten(1).sum(dim=1).float()
        views["pending"] = pending | (m["formed_round"]
                                      > p["cvc"].amax(dim=1)).any(dim=1)
    elif protocol == "multipaxos":
        p = carry["p"]
        rings.append((paxos.ring_spec(n, False), p["ring"]))
        dropped.append(p["mon_io"]["dropped"])
        # per-replica slot counters are each leader's own ledger
        views["formed"] = p["slot"]
        views["stable"] = p["committed_slot"]
        views["commit_seq"] = p["committed_slot"]
        views["view"] = p["view"]
        views["commit_tot"] = p["committed_slot"].sum(dim=1).float()
        views["pending"] = ((p["wl"]["buffer"] > 0).any(dim=1)
                            | p["outstanding"].any(dim=1))
    occ = [ch.ring_occupancy(spec, ring) for spec, ring in rings]
    views["ring_occ"] = occ[0] if len(occ) == 1 else torch.maximum(*occ)
    views["dropped"] = dropped[0] if len(dropped) == 1 \
        else dropped[0] + dropped[1]
    return views


def _arrivals(draws) -> wlmod.Arrivals:
    """A bare [B, T, n] draw table is the trivial mode's Arrivals."""
    if isinstance(draws, wlmod.Arrivals):
        return draws
    return wlmod.Arrivals(draws)


def _tick(carry: Dict, t: torch.Tensor, arr: wlmod.Arrivals, env: Dict,
          cfg: SMRConfig, protocol: str, grace: Optional[torch.Tensor]):
    """One tick of ``protocol`` at tick ``t`` (a 0-dim int32 tensor);
    returns (carry, per-tick outputs that are not read off the carry: the
    closed loop's in-flight counts). Each module runs in its span
    (``core/spans.py``: ``tick.mandator``, ``tick.order``, ``tick.closed``,
    ``tick.monitor``), which a capture records once and a replay never."""
    carry = dict(carry)
    out = {}
    if "m" in carry:
        with spans.span("tick.mandator"):
            carry["m"] = mandator.tick(carry["m"], t, arr, env, cfg)
            lcr = mandator.get_client_requests(carry["m"])
    if protocol in ORDERING:
        with spans.span("tick.order"):
            if protocol == "mandator-sporades":
                carry["s"] = sporades.tick(carry["s"], t, env, cfg, lcr)
            elif protocol == "mandator-paxos":
                carry["p"] = paxos.tick(carry["p"], t, None, env, cfg, True,
                                        lcr=lcr)
            else:
                carry["p"] = paxos.tick(carry["p"], t, arr, env, cfg, False)
    if arr.mode.closed:
        with spans.span("tick.closed"):
            carry, out["inflight"] = _closed_feedback(protocol, carry)
    if "mon" in carry:
        with spans.span("tick.monitor"):
            carry["mon"] = hmon.update(
                carry["mon"], t, cfg, env,
                _monitor_views(protocol, cfg, carry), grace, wlt=arr.wlt,
                inflight=out.get("inflight"),
                # multipaxos closed-loop completion is a pro-rata estimate
                # (see _closed_feedback): the cap is checkable only where
                # done is exact
                check_cap=arr.mode.closed and protocol != "multipaxos")
    return carry, out


def step(carry: Dict, t: torch.Tensor, draws, env: Dict, cfg: SMRConfig,
         protocol: str = "mandator-sporades",
         grace: Optional[torch.Tensor] = None) -> Dict:
    """One tick of ``protocol``. Mandator runs first where it is composed;
    Sporades or Paxos then orders its lastCompletedRounds. ``draws`` is a
    [B, T, n] draw table (trivial mode) or a ``workload.Arrivals``; the
    clients' arrivals land in Mandator or (multipaxos) Paxos. ``grace``:
    the monitor's stall window, where the carry holds a monitor (default:
    ``monitor.stall_grace_ticks``). ``t``: the tick, a 0-dim int32 tensor
    on the env's device (a Python int is converted)."""
    t = _device.tick_index(t, env["delays"].device)
    if grace is None and "mon" in carry:
        grace = hmon.stall_grace_ticks(cfg, env)
    return _tick(carry, t, _arrivals(draws), env, cfg, protocol, grace)[0]


def _trace_leaves(protocol: str, cfg: SMRConfig,
                  reduced: bool = False) -> Dict:
    """The per-tick trace of ``protocol``: {name: (per-lane shape, dtype,
    function of the carry)}. ``cvc`` is the cluster max committed VC;
    with tracing on, the Mandator compositions add ``own_round`` and
    mandator-paxos each origin's own committed-VC view ``cvc_own`` (the
    phase breakdown's stability and delivery boundaries). ``reduced``
    leaves out mandator-sporades' ``commit_key`` and, unless the phase
    breakdown reads it, ``cvc_all`` (``REDUCED_DROPS``)."""
    n = cfg.n_replicas
    i32 = torch.int32
    own = {"own_round": ((n,), i32, lambda c: c["m"]["own_round"])}
    traced = cfg.trace_level != obs.TraceLevel.OFF
    if protocol == "mandator":
        return own
    if protocol == "mandator-paxos":
        leaves = {"cvc": ((n,), i32, lambda c: c["p"]["cvc"].amax(dim=1))}
        if traced:
            leaves.update(own, cvc_own=(
                (n,), i32, lambda c: c["p"]["cvc"].diagonal(dim1=1,
                                                            dim2=2)))
        return leaves
    if protocol == "multipaxos":
        return {"committed_slot": ((n,), i32,
                                   lambda c: c["p"]["committed_slot"])}
    leaves = {"cvc": ((n,), i32, lambda c: c["s"]["cvc"].amax(dim=1)),
              "cvc_all": ((n, n), i32, lambda c: c["s"]["cvc"]),
              "commit_key": ((n,), i32, lambda c: c["s"]["commit_key"]),
              "is_async": ((n,), torch.bool, lambda c: c["s"]["is_async"]),
              "v_cur": ((n,), i32, lambda c: c["s"]["v_cur"])}
    if traced:
        leaves.update(own)
    if reduced:
        del leaves["commit_key"]
        if not traced:
            del leaves["cvc_all"]
    return leaves


def init_run(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict,
             draws, batch: int, device: torch.device):
    """A run's tick-0 carry and the monitor's stall window (None with the
    monitor off). ``draws``: a [B, T, n] draw table (trivial mode) or a
    ``workload.Arrivals``."""
    arr = _arrivals(draws)
    carry = init_carry(cfg, n_ticks, batch, device, protocol,
                       arr.mode.closed)
    grace = None
    if hmon.on(cfg.monitor_level):
        # absent from the carry at the default monitor_level="off"
        grace = hmon.stall_grace_ticks(cfg, env)
        carry["mon"] = hmon.init_monitor(
            cfg, n_ticks, _monitor_views(protocol, cfg, carry))
    return carry, grace


_EAGER_ON_CARD = False


@contextlib.contextmanager
def _eager_on_card():
    """Inside this block, tick loops on the card run eagerly, one Python
    iteration per tick, instead of as a captured graph: the reference the
    graph's parity checks (chip_smoke.py, tests/test_torch_graph_cuda.py)
    and tools/tick_ab.py hold it against. Private on purpose: it is no
    config field, and nothing enters it on a failure."""
    global _EAGER_ON_CARD
    before, _EAGER_ON_CARD = _EAGER_ON_CARD, True
    try:
        yield
    finally:
        _EAGER_ON_CARD = before


# lint: traced-root
def _loop_tick(carry: Dict, t: torch.Tensor, arr: wlmod.Arrivals,
               env: Dict, cfg: SMRConfig, protocol: str,
               grace: Optional[torch.Tensor], leaves: Dict,
               trace: Dict) -> Dict:
    """One iteration of the tick loop, as the graph captures it: the tick,
    its trace columns written at ``t`` on the device (span ``tick.trace``),
    and ``t += 1`` in place."""
    carry, out = _tick(carry, t, arr, env, cfg, protocol, grace)
    with spans.span("tick.trace"):
        at = t.long().view(1)
        for k, (_, _, leaf) in leaves.items():
            trace[k].index_copy_(1, at,
                                 leaf(carry).to(trace[k].dtype)[:, None])
        if arr.mode.closed:
            trace["inflight"].index_copy_(1, at, out["inflight"][:, None])
    t.add_(1)
    return carry


def _tree_key(tree, path=()):
    """(path, shape, dtype, device) of every tensor leaf; None leaves and
    their place included."""
    if isinstance(tree, dict):
        return tuple(x for k in sorted(tree)
                     for x in _tree_key(tree[k], path + (k,)))
    if tree is None:
        return ((path, None),)
    return ((path, tuple(tree.shape), tree.dtype, tree.device),)


def _program_key(protocol: str, cfg: SMRConfig, arr: wlmod.Arrivals,
                 reduced: bool, carry: Dict, inputs: Dict) -> tuple:
    """What one captured tick depends on besides its buffers' contents:
    the protocol, the config (every field: the statics a tick branches
    on), the workload mode and how its arrivals are read, the reduced
    flag, and the shape, dtype and device of every carry leaf and input.
    Sweeps with equal ``experiment.ProgramSignature``s under an equal
    protocol, config and mode have equal keys."""
    return (protocol, cfg, arr.mode, arr.sampling, arr.cut is not None,
            reduced, _tree_key(carry), _tree_key(inputs))


def _setup(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict, draws,
           batch: int, device: torch.device, reduced: bool = False) -> Dict:
    """Everything a tick loop runs on, at tick 0: the carry and the
    monitor's stall window (``init_run``), the trace's leaves and buffers,
    the tick index ``t`` (a 0-dim int32 tensor, 0) and the graph's inputs
    ({"in": read, "out": written in place})."""
    arr = _arrivals(draws)
    carry, grace = init_run(protocol, cfg, n_ticks, env, arr, batch, device)
    leaves = _trace_leaves(protocol, cfg, reduced)
    trace = {k: torch.empty((batch, n_ticks, *shape), dtype=dtype,
                            device=device)
             for k, (shape, dtype, _) in leaves.items()}
    if arr.mode.closed:
        trace["inflight"] = torch.empty((batch, n_ticks, cfg.n_replicas),
                                        dtype=torch.float32, device=device)
    inputs = {"in": {"env": env, "draws": arr.draws, "wlt": arr.wlt,
                     "rate": arr.rate, "epochs": arr.epochs,
                     "grace": grace},
              "out": {"trace": trace, "cut": arr.cut}}
    return {"arr": arr, "carry": carry, "grace": grace, "leaves": leaves,
            "trace": trace, "inputs": inputs,
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def _graph_tick(run: Dict, protocol: str, cfg: SMRConfig):
    """The tick a graph captures, as ``compile_cache.run`` calls it: over
    the program's own buffers (carry, inputs, t)."""
    mode, leaves = run["arr"].mode, run["leaves"]

    def tick(c: Dict, x: Dict, tt: torch.Tensor) -> Dict:
        xi = x["in"]
        a = wlmod.Arrivals(xi["draws"], mode, xi["wlt"], xi["rate"],
                           xi["epochs"], x["out"]["cut"])
        return _loop_tick(c, tt, a, xi["env"], cfg, protocol, xi["grace"],
                          leaves, x["out"]["trace"])
    return tick


def _warm(run: Dict, protocol: str, cfg: SMRConfig) -> Dict:
    """Run the loop's next tick eagerly; the run's carry advances."""
    run["carry"] = _loop_tick(run["carry"], run["t"], run["arr"],
                              run["inputs"]["in"]["env"], cfg, protocol,
                              run["grace"], run["leaves"], run["trace"])
    return run


def program_key(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict,
                draws, batch: int, device: torch.device,
                reduced: bool = False) -> tuple:
    """The key of the tick program a run of these inputs replays on the
    card (``_program_key``), computed on any device: set up and warm one
    tick, as ``_scan_body`` does before it captures. Equal keys share one
    captured program."""
    run = _warm(_setup(protocol, cfg, n_ticks, env, draws, batch, device,
                       reduced), protocol, cfg)
    return _program_key(protocol, cfg, run["arr"], reduced, run["carry"],
                        run["inputs"])


def _start_scan(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict,
                draws, batch: int, device: torch.device,
                reduced: bool = False):
    """Set the tick loop up and start it. Returns (run, replays): where
    the loop runs eagerly it has run, and ``replays`` is None; on the card
    the warm-up tick has run and ``replays`` (``compile_cache.Replays``)
    enqueues the rest. Spans: the set-up and tick 0 are ``sweep.tick0``,
    an eager loop's other ticks ``sweep.enqueue``."""
    with spans.span("sweep.tick0"):
        run = _setup(protocol, cfg, n_ticks, env, draws, batch, device,
                     reduced)
        if n_ticks:
            _warm(run, protocol, cfg)                       # the warm-up
    if device.type != "cuda" or _EAGER_ON_CARD or n_ticks < 2:
        with spans.span("sweep.enqueue"):
            for _ in range(n_ticks - 1):
                _warm(run, protocol, cfg)
        compile_cache.count_eager(n_ticks)
        return run, None
    key = _program_key(protocol, cfg, run["arr"], reduced, run["carry"],
                       run["inputs"])
    return run, compile_cache.start(key, protocol,
                                    _graph_tick(run, protocol, cfg),
                                    run["carry"], run["inputs"], run["t"],
                                    n_ticks - 1)


def _scan_body(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict,
               draws, batch: int, device: torch.device,
               reduced: bool = False):
    """The tick loop. ``draws``: a [B, T, n] draw table (trivial mode) or
    a ``workload.Arrivals``. Returns (final carry, trace) with trace
    leaves [B, T, ...] (``_trace_leaves``, plus ``inflight`` [B, T, n] in
    closed mode), tensors of this run alone.

    On the CPU, and on the card inside ``_eager_on_card()``, the loop runs
    one Python iteration per tick (``_loop_tick``). Otherwise tick 0 runs
    eagerly as the warm-up, and ticks 1 .. n-1 are replays of one tick
    captured as a CUDA graph (``compile_cache.start``; captured on the
    first run of its program, replayed by every later one)."""
    run, replays = _start_scan(protocol, cfg, n_ticks, env, draws, batch,
                               device, reduced)
    if replays is not None:
        replays.step()
        run["carry"] = replays.finish()
    return run["carry"], run["trace"]


def _weighted_quantile(vals: torch.Tensor, weights: torch.Tensor,
                       q: float) -> torch.Tensor:
    """Weighted quantile over the last axis; zero-weight entries are inert
    (they only flatten the CDF). vals, weights: [..., M] -> [...].

    The CDF's running sums are float64 sums rounded to float32, as the
    CPU's float32 cumsum gives them; CUDA's float32 cumsum scans in
    float32 in another order."""
    order = torch.argsort(vals, dim=-1, stable=True)
    v = torch.gather(vals, -1, order)
    w = torch.gather(weights, -1, order)
    # lint: allow(dtype-hygiene): exact running sums of float32
    # weights (order-free on every device; ROADMAP Queue C, PR 16)
    cum = torch.cumsum(w.double(), dim=-1).float()
    tot = cum[..., -1:]
    cdf = cum / torch.where(tot > 0, tot, 1.0)
    qv = torch.full(cdf.shape[:-1] + (1,), q, dtype=cdf.dtype,
                    device=cdf.device)
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), qv, right=False),
                      0, v.shape[-1] - 1)
    out = torch.gather(v, -1, idx)
    return torch.where(tot > 0, out, float("nan"))[..., 0]


def _batch_metrics(cfg: SMRConfig, create_t, arr_mean, count, commit_t,
                   warmup_frac=0.15, bucket_ms=500.0,
                   reduced: bool = False) -> Dict:
    """Metrics over batch records [B, n, R] (ticks -> ms via cfg.tick_ms),
    on the device, per lane. ``reduced`` returns the scalars alone
    (throughput, median_ms, p99_ms, committed), computed by the same
    operations; the timelines and per-origin quantiles are not computed.

    The sums of float32 terms (throughput, committed, the timelines and
    the per-origin latency sums) are taken in float64 and rounded once to
    float32. A float64 sum of float32 terms is exact unless they span more
    than 53 bits (a total above 2^30 with terms below 2^-22 in it), so in
    the simulator's range no order of summation can move the result. In
    float32 the CUDA reduction and the CPU's add in other orders, and
    ``scatter_add_`` adds by atomics in no fixed order on the card (the
    per-origin latency timeline differed from run to run)."""
    B, n = count.shape[:2]
    n_ticks = netsim.sim_ticks(cfg)
    ok = torch.isfinite(commit_t) & (count > 0) & torch.isfinite(create_t)
    lat_ms = (commit_t - arr_mean) * cfg.tick_ms
    w0 = warmup_frac * n_ticks
    in_win = ok & (commit_t >= w0)
    win_s = (n_ticks - w0) * cfg.tick_ms / 1000.0
    w_o = torch.where(in_win, count, 0.0)                     # [B, n, R]
    w = w_o.reshape(B, -1)
    if win_s > 0:
        # a tensor divisor: CUDA divides by a Python scalar as a product
        # with its float32 reciprocal, one ulp off the CPU's quotient
        # lint: allow(dtype-hygiene): exact sum of float32 counts,
        # rounded once (ROADMAP Queue C, PR 16)
        tot = w.double().sum(dim=1).float()
        tput = tot / torch.full_like(tot, win_s)
    else:
        tput = torch.zeros(B, dtype=torch.float32, device=count.device)
    lat_flat = lat_ms.reshape(B, -1)
    med = _weighted_quantile(lat_flat, w, 0.5)
    p99 = _weighted_quantile(lat_flat, w, 0.99)
    cnt_ok = torch.where(ok, count, 0.0)
    # lint: allow(dtype-hygiene): exact sum of float32 counts,
    # rounded once (ROADMAP Queue C, PR 16)
    committed = cnt_ok.reshape(B, -1).double().sum(dim=1).float()
    if reduced:
        return {"throughput": tput, "median_ms": med, "p99_ms": p99,
                "committed": committed}
    nbuck = int(math.ceil(n_ticks * cfg.tick_ms / bucket_ms))
    b = torch.where(ok, commit_t * (cfg.tick_ms / bucket_ms), 0.0
                    ).to(torch.int32).clamp(0, nbuck - 1).long()

    def bucket_sum(*shape, index, src):
        """scatter_add_ of float32 ``src`` along the last axis, exact."""
        # lint: allow(dtype-hygiene): exact bucket sums of float32
        # terms, rounded once (ROADMAP Queue C, PR 16)
        return torch.zeros(shape, dtype=torch.float64, device=count.device
                           ).scatter_add_(len(shape) - 1, index,
                                          src.double()).float()

    timeline = bucket_sum(B, nbuck, index=b.reshape(B, -1),
                          src=cnt_ok.reshape(B, -1))
    timeline = timeline / (bucket_ms / 1000.0)
    # per-origin client-perceived latency: where is the latency paid?
    med_o = _weighted_quantile(lat_ms, w_o, 0.5)
    p99_o = _weighted_quantile(lat_ms, w_o, 0.99)
    tl_o = bucket_sum(B, n, nbuck, index=b, src=cnt_ok)
    lat_sum = bucket_sum(B, n, nbuck, index=b,
                         src=cnt_ok * torch.where(ok, lat_ms, 0.0))
    lat_tl_o = torch.where(tl_o > 0, lat_sum / torch.clamp(tl_o, min=1e-9),
                           float("nan"))
    return {"throughput": tput, "median_ms": med, "p99_ms": p99,
            "timeline": timeline,
            "committed": committed,
            "origin_median_ms": med_o, "origin_p99_ms": p99_o,
            "origin_timeline": tl_o / (bucket_ms / 1000.0),
            "origin_lat_ms_timeline": lat_tl_o}


def _latency_sketch(cfg: SMRConfig, create_t, arr_mean, count, commit_t,
                    warmup_frac=0.15):
    """The committed-latency distribution as a 64-bin sketch per lane
    ({"v", "w"} [B, SKETCH_BINS] float32, on the device), over the same
    measurement window and weights as ``_batch_metrics``, and the largest
    lane's in-window weight (0-dim float64, on the device): it must stay
    below ``SKETCH_EXACT_WEIGHT`` for the running sums to be exact, which
    ``_check_weight`` asserts once the results are read back."""
    B = count.shape[0]
    n_ticks = netsim.sim_ticks(cfg)
    ok = torch.isfinite(commit_t) & (count > 0) & torch.isfinite(create_t)
    lat_ms = (commit_t - arr_mean) * cfg.tick_ms
    in_win = ok & (commit_t >= warmup_frac * n_ticks)
    w = torch.where(in_win, count, 0.0).reshape(B, -1)
    # lint: allow(dtype-hygiene): an exact total of float32 counts
    # for the sketch's 2^24 check, read after the run
    top = w.double().sum(dim=1).max()
    # zero-weight rows may hold inf/nan latencies (uncommitted batches);
    # the sketch masks them instead of multiplying through
    return dsketch.build(lat_ms.reshape(B, -1), w), top


def _check_weight(top: float) -> None:
    if top >= SKETCH_EXACT_WEIGHT:
        raise ValueError(f"a lane's in-window weight {top} reaches 2^24: "
                         "the sketch's float32 running sums would round")


def _check_cut(cut: bool) -> None:
    if cut:
        raise ValueError("draws replays the closed lanes' counts after the "
                         "cap, but the cap cut one: the replayed counts are "
                         "not this run's")


def _vc_commit_ticks(cvc_trace: torch.Tensor, r_max: int) -> torch.Tensor:
    """cvc_trace: [B, T, n] monotone. Returns [B, n, r_max] where column r
    is the commit tick of batch (k, r); rounds are 1-based so column 0 is
    inf, and inf marks rounds that never commit."""
    B, ticks, n = cvc_trace.shape
    seq = cvc_trace.transpose(1, 2).contiguous()              # [B, n, T]
    rs = torch.arange(r_max, dtype=seq.dtype, device=seq.device)
    idx = torch.searchsorted(seq, rs.expand(B, n, r_max).contiguous(),
                             right=False)
    valid = (idx < ticks) & (rs >= 1)
    return torch.where(valid, idx.float(), float("inf"))


def _lane_tables(wlt: Dict, batch: int, device: torch.device) -> Dict:
    """The grid's workload tables on ``device``: rate_of [B, W, n] and
    think_ticks / cap / closed [B] float32, win_of_tick [B, T] int64."""
    out = {}
    for k in ("rate_of", "closed", "think_ticks", "cap"):
        out[k] = _device.to_device(wlt[k], device, torch.float32)
    out["win_of_tick"] = _device.to_device(wlt["win_of_tick"], device,
                                           torch.int64)
    if out["rate_of"].shape[0] != batch:
        raise ValueError(f"wlt holds {out['rate_of'].shape[0]} lanes, the "
                         f"grid {batch}")
    return out


def make_arrivals(cfg: SMRConfig, mode: WorkloadMode,
                  rate_per_tick: Sequence[float], seeds: Sequence[int],
                  device: torch.device, wlt: Optional[Dict] = None,
                  draws=None, epochs=None) -> wlmod.Arrivals:
    """The arrivals of a grid's run (see ``sim_point``): open lanes read
    ``draws`` ([B, T, n]; default ``workload.draw_table`` from the seeds),
    closed lanes sample ``epochs`` ([B, n, M] float64; default
    ``workload.epoch_stream`` from the seeds) — unless ``draws`` is given
    and ``epochs`` is not: then every lane replays ``draws``. What comes
    from the host goes to the card without waiting on it
    (``device.to_device``); the draws are made on the card."""
    n_ticks, batch, n = netsim.sim_ticks(cfg), len(seeds), cfg.n_replicas
    host_wlt = None if mode.trivial else wlt
    if mode.trivial:
        wlt = None
    elif wlt is None:
        raise ValueError(f"{mode} needs the grid's workload tables (wlt)")
    else:
        wlt = _lane_tables(wlt, batch, device)
    replay = mode.closed and draws is not None and epochs is None
    if draws is None:
        draws = wlmod.draw_table(rate_per_tick, seeds, n_ticks, n, device,
                                 host_wlt)
    draws = _device.to_device(draws, device, torch.float32)
    if tuple(draws.shape) != (batch, n_ticks, n):
        raise ValueError(f"draws must be [B, T, n] = {(batch, n_ticks, n)}, "
                         f"got {tuple(draws.shape)}")
    if mode.closed and not replay:
        if epochs is None:
            epochs = wlmod.epoch_stream(rate_per_tick, seeds, host_wlt,
                                        n_ticks, n, device)
        # lint: allow(dtype-hygiene): the closed lanes' epoch stream
        # is float64 (a time-changed unit-rate Poisson process)
        epochs = _device.to_device(epochs, device,
                                   torch.float64).contiguous()
        if epochs.dim() != 3 or tuple(epochs.shape[:2]) != (batch, n):
            raise ValueError(f"epochs must be [B, n, M] with (B, n) = "
                             f"{(batch, n)}, got {tuple(epochs.shape)}")
    else:
        epochs = None
    rate = _device.to_device(list(rate_per_tick), device, torch.float32)
    cut = torch.zeros(batch, dtype=torch.bool, device=device) \
        if replay else None
    return wlmod.Arrivals(draws, mode, wlt, rate, epochs, cut)


def sim_point(protocol: str, cfg: SMRConfig, env: Dict,
              rate_per_tick: Sequence[float], seeds: Sequence[int],
              draws: Optional[torch.Tensor] = None,
              mode: WorkloadMode = TRIVIAL_MODE, device=None,
              wlt: Optional[Dict] = None,
              epochs: Optional[torch.Tensor] = None,
              reduced: bool = False) -> Dict:
    """Every lane of a batched grid, end to end: tick loop + on-device
    metric extraction. env: batched env (leaves [B, ...], see
    netsim.stack_envs); rate_per_tick, seeds: per lane; ``mode``: the
    grid's workload mode, ``wlt`` its workload tables stacked per lane
    (``experiment._lower_workloads``; required unless ``mode.trivial``).
    ``cfg.delay_horizon_ticks`` must be resolved to an int.

    Arrivals (``make_arrivals``): open lanes read ``draws`` ([B, T, n]
    counts; default ``workload.draw_table`` from the seeds). Closed lanes
    sample ``epochs`` ([B, n, M] float64, ``workload.epoch_stream``;
    default from the seeds) — unless ``draws`` is given and ``epochs`` is
    not: then every lane replays ``draws``, closed lanes' counts being the
    counts after the cap, and a cap that cuts one raises ValueError.

    Returns a dict of [B, ...] tensors: the metrics of every protocol,
    plus async_frac, views, cvc_all and commit_key for mandator-sporades;
    ``inflight_max`` in closed mode; the phase breakdown and ``obs`` (the
    layers' trace rings) with tracing on; ``mon`` with monitoring on.

    ``reduced`` is the reduced sweep path's contract: the scalars are
    computed by the same operations (bitwise equal to the unreduced
    run's), the keys of ``REDUCED_DROPS`` are neither computed nor
    returned, and ``sketch`` ({"v", "w"} [B, 64], ``_latency_sketch``)
    takes their place.

    ``sim_point`` is ``PointRun`` run to its end and its checks read
    (``PointResult.checked``); the sweep engine keeps the two apart."""
    run = PointRun(protocol, cfg, env, rate_per_tick, seeds, draws, mode,
                   device, wlt, epochs, reduced)
    run.advance()
    return run.finish().checked()


class PointResult:
    """A run's results on its device, before anything is read back:
    ``out`` (``sim_point``'s dict of [B, ...] tensors) and ``checks``,
    (0-dim flag tensor, function of its host value that raises) pairs
    ``checked`` reads. ``program`` keeps the captured program the run
    replayed alive until then (None for an eager run)."""

    def __init__(self, out: Dict,
                 checks: List[Tuple[torch.Tensor, Callable]],
                 program=None):
        self.out, self.checks, self.program = out, checks, program

    def checked(self) -> Dict:
        """Read the checks' flags back (this waits for the run) and raise
        as the first failing one says; else return ``out``."""
        for flag, check in self.checks:
            check(flag.item())
        return self.out


class PointRun:
    """One batched grid's tick loop on its device, started and not waited
    for: the constructor sets the run up (``make_arrivals``) and starts
    its loop (``_start_scan``: the CPU runs it all; the card runs the
    warm-up tick, captures the program if it is new, and loads the run
    into its buffers); ``replays`` is the number of the card's replays
    (0 where the loop has run); ``advance(n)`` enqueues up to ``n`` of
    them; ``finish()`` copies the results out and extracts the metrics,
    all enqueued (``PointResult``). Nothing between the constructor and
    ``finish`` reads a value of the card back, except a first capture.
    Spans (``core/spans.py``): ``sweep.arrivals``, ``sweep.tick0``,
    ``sweep.capture``, ``sweep.load``, ``sweep.enqueue``,
    ``sweep.finish``. Arguments as ``sim_point``'s."""

    def __init__(self, protocol: str, cfg: SMRConfig, env: Dict,
                 rate_per_tick: Sequence[float], seeds: Sequence[int],
                 draws=None, mode: WorkloadMode = TRIVIAL_MODE, device=None,
                 wlt: Optional[Dict] = None, epochs=None,
                 reduced: bool = False):
        check_supported(protocol, cfg, mode)
        self.device = dev = _device.resolve(device)
        if not isinstance(cfg.delay_horizon_ticks, int):
            raise ValueError("sim_point needs a resolved horizon; call "
                             "netsim.resolve_horizon first")
        self.protocol, self.cfg, self.reduced = protocol, cfg, reduced
        with _device.on(dev):
            with spans.span("sweep.arrivals"):
                env = {k: _device.to_device(v, dev) for k, v in env.items()}
                self.arr = make_arrivals(cfg, mode, rate_per_tick, seeds,
                                         dev, wlt, draws, epochs)
            self._run, self._replays = _start_scan(
                protocol, cfg, netsim.sim_ticks(cfg), env, self.arr,
                len(seeds), dev, reduced)
        self.replays = 0 if self._replays is None else self._replays.left

    def advance(self, n: Optional[int] = None) -> bool:
        """Enqueue up to ``n`` more replays (all with None); True while
        some are left."""
        if self._replays is None:
            return False
        with _device.on(self.device), spans.span("sweep.enqueue"):
            return self._replays.step(n)

    def finish(self) -> PointResult:
        run, replays = self._run, self._replays
        with _device.on(self.device), spans.span("sweep.finish"):
            if replays is not None:
                run["carry"] = replays.finish()
            res = _results(self.protocol, self.cfg, run["carry"],
                           run["trace"], self.arr, self.reduced)
        res.program = None if replays is None else replays.program
        return res


def _results(protocol: str, cfg: SMRConfig, st: Dict, trace: Dict,
             arr: wlmod.Arrivals, reduced: bool = False) -> PointResult:
    """``sim_point``'s results from a run's final carry and trace, on the
    device. Its checks, in the order they raise: a replayed closed count
    the cap cut, a closed lane past its epoch stream, the sketch's
    weight."""
    n_ticks = netsim.sim_ticks(cfg)
    mode = arr.mode
    wl = st["p" if protocol == "multipaxos" else "m"]["wl"]
    checks = []
    if arr.cut is not None:
        checks.append((arr.cut.any(), _check_cut))
    overrun = wlmod.epochs_overrun(wl, arr)
    if overrun is not None:
        checks.append((overrun, wlmod.raise_if_overrun))
    if protocol == "mandator":
        # dissemination completion = "commit" for availability accounting
        cvc = trace["own_round"]
    elif protocol == "multipaxos":
        cvc = trace["committed_slot"]
    else:
        # batch r commits once the committed VC reaches r (1-based rounds)
        cvc = trace["cvc"]
    commit_t = _vc_commit_ticks(cvc, wl["batch_count"].shape[2])
    out = _batch_metrics(cfg, wl["batch_create_t"], wl["batch_arr_mean"],
                         wl["batch_count"], commit_t, reduced=reduced)
    if protocol == "mandator-sporades":
        out["async_frac"] = async_frac(trace["is_async"])
        out["views"] = trace["v_cur"].flatten(1).amax(dim=1)
        if not reduced:
            out["cvc_all"] = trace["cvc_all"]          # [B, ticks, n, n]
            out["commit_key"] = trace["commit_key"]    # [B, ticks, n]
    if mode.closed:
        out["inflight_max"] = trace["inflight"].amax(dim=1)      # [B, n]
    if cfg.trace_level != obs.TraceLevel.OFF:
        out.update(_phase_breakdown(protocol, cfg, wl, trace, commit_t,
                                    n_ticks, reduced=reduced))
        out["obs"] = {layer: obs.public_view(st[k]["tr"])
                      for k, layer in (("m", "mandator"), ("s", "sporades"),
                                       ("p", "paxos"))
                      if k in st and "tr" in st[k]}
    if hmon.on(cfg.monitor_level):
        out["mon"] = hmon.public_view(st["mon"], n_ticks)
    if reduced:
        out["sketch"], top = _latency_sketch(
            cfg, wl["batch_create_t"], wl["batch_arr_mean"],
            wl["batch_count"], commit_t)
        checks.append((top, _check_weight))
    return PointResult(out, checks)


def async_frac(is_async: torch.Tensor) -> torch.Tensor:
    """[B] share of each lane's replica-ticks in the asynchronous view:
    the count over the size, rounded once in float32 (2 248 of 10 000 is
    0.2248). Not ``mean``: on the card it multiplies the sum by
    float32(1 / size), as the JAX package's ``jnp.mean`` does on XLA:CPU,
    and reads 0.22479999 there; a division by a host scalar does the same
    on the card, so the size is a device tensor."""
    count = is_async.flatten(1).sum(dim=1).float()
    return count / torch.full_like(count, is_async[0].numel())


def run_sim(protocol: str, cfg: SMRConfig, rate_tx_s: float,
            scenario=None, seed: int = 0, workload=None,
            canonical: bool = True, device=None, draws=None) -> Dict:
    """Single-point wrapper over the sweep engine (``experiment.
    run_sweep``): one rate, seed, scenario (None: fault-free) and workload
    (None: the §5.2 baseline); returns its row. ``device`` and ``draws``
    (a [1, T, n] arrival table) as ``run_sweep``'s."""
    from repro_torch.core.experiment import SweepSpec, run_sweep
    spec = SweepSpec(rates=(float(rate_tx_s),), seeds=(int(seed),),
                     scenarios=(scenario,), workloads=(workload,))
    return run_sweep(protocol, cfg, spec, device=device, draws=draws,
                     canonical=canonical)[0]


def _phase_breakdown(protocol: str, cfg: SMRConfig, wl: Dict, trace: Dict,
                     commit_t: torch.Tensor, n_ticks: int,
                     warmup_frac: float = 0.15,
                     reduced: bool = False) -> Dict:
    """Latency-breakdown accounting (``obs.PHASES``): split each committed
    batch's end-to-end latency at three protocol boundaries — batch
    creation at the origin (queue | dissemination), stability (n-f
    dissemination votes; dissemination | consensus), and global commit
    (consensus | delivery, the origin's own observation). The four phase
    marks telescope back to the client-perceived latency of
    ``_batch_metrics``: same arrival mean, same commit reconstruction.
    ``reduced`` leaves out the per-batch marks (``REDUCED_DROPS``)."""
    r_max = wl["batch_count"].shape[2]
    create_t, arr_t = wl["batch_create_t"], wl["batch_arr_mean"]
    cnt = wl["batch_count"]
    if protocol == "mandator":
        # dissemination IS the protocol: completion == commit == delivery
        stable_t = deliv_t = commit_t
    elif protocol in ("mandator-sporades", "mandator-paxos"):
        # stability = the origin's own chain completing the round
        stable_t = _vc_commit_ticks(trace["own_round"], r_max)
        own_cvc = (trace["cvc_all"].diagonal(dim1=2, dim2=3)
                   if protocol == "mandator-sporades" else trace["cvc_own"])
        deliv_t = _vc_commit_ticks(own_cvc, r_max)
    else:  # multipaxos: monolithic — the slot batch enters consensus as
        # it forms, and commit is observed at the committing leader
        stable_t = create_t
        deliv_t = commit_t
    marks = torch.stack([create_t, stable_t, commit_t, deliv_t], dim=1)
    prev = torch.stack([arr_t, create_t, stable_t, commit_t], dim=1)
    phases_ms = torch.clamp(marks - prev, min=0.0) * cfg.tick_ms  # [B,4,n,R]
    ok = torch.isfinite(marks).all(dim=1) & (cnt > 0)
    in_win = ok & (commit_t >= warmup_frac * n_ticks)   # same window as
    w = torch.where(in_win, cnt, 0.0)                   # _batch_metrics
    flat = phases_ms.flatten(2)                                  # [B,4,nR]
    w_flat = w.flatten(1)[:, None, :].expand_as(flat)
    w_orig = w[:, None].expand_as(phases_ms)
    out = {"phase_med_ms": _weighted_quantile(flat, w_flat, 0.5),  # [B, 4]
           "phase_p99_ms": _weighted_quantile(flat, w_flat, 0.99),
           "phase_origin_med_ms": _weighted_quantile(phases_ms, w_orig,
                                                     0.5),   # [B, 4, n]
           "phase_origin_p99_ms": _weighted_quantile(phases_ms, w_orig,
                                                     0.99)}
    if cfg.trace_level == obs.TraceLevel.FULL and not reduced:
        out["batch_marks_t"] = marks      # absolute ticks, inf = never
        out["batch_arr_t"] = arr_t
        out["batch_n"] = cnt
    return out
