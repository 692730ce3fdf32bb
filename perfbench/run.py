"""Run one cell of the benchmark of ``repro_torch``'s sweep engine once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration (a
deployment of the WAN simulator: protocol and ``SMRConfig``) and a traffic
mix (the sweep grid's axes and length, ``traffic/<name>.json``). The run:

1. set-up: CUDA, the port, its kernels (built into ``build/`` inside the
   checkout on a first run), and one warm grid of the cell's own shape
   through ``dispatch_sweep`` (it captures the tick program); then every
   window grid's arrivals, made with NumPy from ``--seed`` (``pb_inputs``);
2. the window: grids of the cell's shape, each with fresh seeds, through
   ``repro_torch.core.experiment.dispatch_sweep``, grid k+1 dispatched
   before grid k is collected, until ``--seconds`` have passed; then the
   last grid is collected. ``lane_ticks_per_s`` is every collected grid's
   lanes x ticks over the wall time from the first dispatch to the last
   collect; ``peak_mem_mib`` the allocator's peak over the window;
   ``setup_s`` the time from process start to the window;
3. with ``--trace 1``, after the window, one grid boundary more in the
   window's own schedule runs under ``torch.profiler`` (``pb_trace``;
   ``traced_boundary``) and each per-layer metric's reader
   (``metrics/<name>.py``) reads the trace and the port's counters;
4. the check (``pb_check``): a sample of one collected grid's lanes
   simulated again by the plain reference (``plainsim``) on the CPU, every
   value compared.

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. Without a CUDA device, or with fewer than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import pb_check  # noqa: E402
import pb_inputs  # noqa: E402
import pb_registry  # noqa: E402
import pb_trace  # noqa: E402
import plainsim  # noqa: E402

# top-level module names no run may hold once its window has closed: JAX
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# window inputs made beyond the window's expected need, and their cap
SPARE_GRIDS, MAX_GRIDS = 2, 64
# graph replays of each grid a traced boundary profiles; the marker
# kernels' length in cycles
TRACE_REPLAYS, MARK_CYCLES = 64, 500


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


class Port:
    """The system under test: ``repro_torch``'s sweep engine on one
    device, and the libraries its scenarios and workloads are named in.
    ``stage`` hands a grid's draws to it as a host tensor that it copies
    to the card as it is (pinned where there is a card), so that a
    dispatch in the window pins nothing the benchmark made."""

    def __init__(self, device):
        from repro_torch.configs.smr import SMRConfig
        from repro_torch.core import compile_cache, experiment
        from repro_torch.scenarios import library as scl
        from repro_torch.workloads import library as wll
        self.SMRConfig, self.experiment = SMRConfig, experiment
        self.compile_cache, self.scl, self.wll = compile_cache, scl, wll
        self.device = device
        self._staged: Dict[int, tuple] = {}

    def stage(self, g: pb_inputs.Grid):
        """The draws of ``g`` as a host tensor, made once."""
        if id(g) not in self._staged:
            import torch
            t = torch.from_numpy(g.draws)
            self._staged[id(g)] = (g, t.pin_memory() if _cuda(self.device)
                                   else t)
        return self._staged[id(g)][1]

    def dispatch(self, protocol: str, settings: Dict, g: pb_inputs.Grid):
        spec = self.experiment.SweepSpec(
            **pb_inputs.spec_kwargs(settings, g, self.scl, self.wll))
        return self.experiment.dispatch_sweep(
            protocol, self.SMRConfig(**settings), spec, device=self.device,
            draws=self.stage(g))


def _cuda(device) -> bool:
    return str(device).startswith("cuda")


def traced_boundary(port: Port, protocol: str, settings: Dict,
                    ga: pb_inputs.Grid, gb: pb_inputs.Grid, ticks: int,
                    replays: int = TRACE_REPLAYS):
    """One grid boundary under ``torch.profiler``, in the window's own
    schedule: grid ``ga`` is dispatched, ``gb`` is dispatched before ``ga``
    is collected. The profiler starts as ``ga``'s last ``replays`` graph
    replays are issued (``torch.cuda.CUDAGraph.replay`` is wrapped to
    count them), a marker kernel goes on the stream once ``ga``'s dispatch
    has returned and another just before ``gb``'s first replay, and the
    profiler stops, in this thread with the device drained, once ``gb``
    has issued ``replays`` replays. Returns (both pending sweeps, the
    ``pb_trace.Timeline`` or None, timings)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    graph = torch.cuda.CUDAGraph
    original = graph.replay
    state = {"grid": 0, "k": 0, "on": False, "done": False}
    start_at = max(0, ticks - 1 - replays)
    times: Dict = {}

    def stop():
        if state["on"] and not state["done"]:
            state["done"] = True
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prof.stop()
            times["stop_s"] = time.perf_counter() - t1

    def replay(self):
        state["k"] += 1
        k = state["k"]
        if state["grid"] == 0 and k == start_at + 1:
            prof.start()
            state["on"] = True
        if state["grid"] == 1 and k == 1:
            torch.cuda._sleep(MARK_CYCLES)
        original(self)
        if state["grid"] == 1 and k >= replays:
            stop()
        times[f"replays_{state['grid']}"] = k
    graph.replay = replay
    try:
        pa = port.dispatch(protocol, settings, ga)
        if state["on"]:
            torch.cuda._sleep(MARK_CYCLES)
        state["grid"], state["k"] = 1, 0
        pb = port.dispatch(protocol, settings, gb)
    finally:
        graph.replay = original
        stop()
    t1 = time.perf_counter()
    tl = pb_trace.from_profiler(prof) if state["on"] else None
    times["parse_s"] = time.perf_counter() - t1
    times["events"] = 0 if tl is None else len(tl.events)
    times["marks"] = 0 if tl is None else len(tl.marks)
    return [pa, pb], tl, times


def run_cell(cell: pb_registry.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None) -> Dict:
    """One run of ``cell``: the result line's fields, and ``_info`` for
    standard error. ``device`` is the port's device: "cuda" in every run
    of the benchmark; the tests pass "cpu" (where nothing is traced)."""
    import torch
    t_start = T_START if t_start is None else t_start
    cuda = _cuda(device)
    port = Port(device)
    cc = port.compile_cache
    traffic, protocol = cell.traffic, cell.config["protocol"]
    settings = pb_inputs.smr_settings(cell.config, traffic)
    ticks = pb_inputs.sim_ticks(settings)

    # set-up: one warm grid of the cell's shape captures its tick program
    warm = pb_inputs.make_grid(settings, traffic, seed, 0)
    port.stage(warm)
    t0 = time.perf_counter()
    port.dispatch(protocol, settings, warm).collect()
    warm_s = time.perf_counter() - t0
    setup_stats = cc.stats()
    # the window's grids, with room for grids faster than the warm one;
    # should the window need more, it takes them again from the first
    grid_s = max(warm_s - setup_stats["capture_s"], 1e-3)
    n_grids = min(MAX_GRIDS, max(3, math.ceil(1.25 * seconds / grid_s)
                                 + SPARE_GRIDS))
    grids = [pb_inputs.make_grid(settings, traffic, seed, k + 1)
             for k in range(n_grids)]
    for g in grids:
        port.stage(g)
    cc.reset_stats()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # the window
    used: List[pb_inputs.Grid] = []
    rows: List[List[Dict]] = []
    t0 = time.perf_counter()
    pending = [port.dispatch(protocol, settings, grids[0])]
    used.append(grids[0])
    while pending:
        nxt = None
        if time.perf_counter() - t0 < seconds:
            g = grids[len(used) % len(grids)]
            nxt = port.dispatch(protocol, settings, g)
            used.append(g)
        rows.append(pending.pop(0).collect())
        if nxt is not None:
            pending.append(nxt)
    wall = time.perf_counter() - t0
    window_stats = cc.stats()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_grids = len(used)
    timeline, trace_times = None, None
    if trace and cuda:
        # one boundary more, profiled, in the window's schedule
        pair = [grids[(len(used) + i) % len(grids)] for i in range(2)]
        both, timeline, trace_times = traced_boundary(
            port, protocol, settings, pair[0], pair[1], ticks)
        for p, g in zip(both, pair):
            rows.append(p.collect())
            used.append(g)

    # the check, after the window
    t_ref = time.perf_counter()
    gi, lanes = pb_check.sample_lanes(seed, used)
    ref = pb_check.reference_rows(protocol, cell.config, traffic, used[gi],
                                  lanes)
    checks = pb_check.compare(rows, used, gi, lanes, ref)
    checks["lanes_wanted"] = len(lanes)
    ref_s = time.perf_counter() - t_ref

    metrics: Dict[str, Dict] = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        values = {"lane_ticks_per_s": lane_ticks_per_s(
            used[:window_grids], ticks, wall),
            "peak_mem_mib": peak / 2 ** 20, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": values[m.name], "unit": m.unit}
    else:
        dep = plainsim.deployment(cell.config, traffic.get("smr"))
        obs = {"setup_stats": setup_stats, "window_stats": window_stats,
               "timeline": timeline, "replays": TRACE_REPLAYS,
               "ticks": ticks, "grid_lanes": used[0].lanes,
               "ring_bytes": plainsim.ring_bytes(protocol, dep,
                                                 used[0].lanes)}
        for m in cell.per_layer:
            v = cell.reader(m.name)(obs)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        if timeline is not None:
            device_info["busy_s"] = pb_trace.busy_us(
                timeline.events, timeline.lo, timeline.hi) / 1e6
            device_info["window_s"] = (timeline.hi - timeline.lo) / 1e6
            breakdown = {"device_ops": pb_trace.top_ops(timeline),
                         "idle_gaps": pb_trace.top_gaps(timeline)}
    max_ulps = pb_check.MAX_ULPS
    correct = (checks["exact_mismatches"] == 0 and checks["rows_short"] == 0
               and checks["max_ulps"] <= max_ulps
               and checks["lanes_checked"] >= checks["lanes_wanted"])
    out = {"correct": bool(correct),
           "attempted": sum(g.lanes for g in used),
           "failed": checks["rows_short"] + sum(
               1 for w in checks["where"] if w[5] or w[6] > max_ulps),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {
        "exact_mismatches": {"value": checks["exact_mismatches"],
                             "limit": 0},
        "max_ulps": {"value": checks["max_ulps"], "limit": max_ulps},
        "rows_short": {"value": checks["rows_short"], "limit": 0},
        "lanes_checked": {"value": checks["lanes_checked"],
                          "limit": checks["lanes_wanted"]}}
    out["_info"] = {"grids": window_grids, "wall_s": wall, "warm_s": warm_s,
                    "ref_s": ref_s, "grid_wall_ms": wall / window_grids * 1e3,
                    "trace": trace_times, "checked": [gi, lanes],
                    "mismatch_paths": checks["paths"],
                    "mismatch_lanes": checks["where"],
                    "captures_setup": setup_stats["captures"],
                    "capture_s": setup_stats["capture_s"],
                    "build_misses": setup_stats["build_misses"],
                    "window_captures": window_stats["captures"]}
    return out


def lane_ticks_per_s(grids, ticks: int, wall: float) -> float:
    """The window's rate: every collected grid's lanes x ticks over the
    wall time from the first dispatch to the last collect."""
    return sum(g.lanes for g in grids) * ticks / wall


def check_lines(out: Dict) -> List[str]:
    """The numbers compared, each beside its limit."""
    c = out["checks"]
    return [f"check: exact_mismatches {c['exact_mismatches']['value']} "
            f"(limit {c['exact_mismatches']['limit']}: integer values, "
            "shapes and keys vs the reference)",
            f"check: max_ulps {c['max_ulps']['value']} (limit "
            f"{c['max_ulps']['limit']}: float32 units in the last place "
            "vs the reference)",
            f"check: rows_short {c['rows_short']['value']} (limit "
            f"{c['rows_short']['limit']})",
            f"check: lanes_checked {c['lanes_checked']['value']} (limit "
            f">= {c['lanes_checked']['limit']})",
            f"check: correct {out['correct']}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    try:
        bench = pb_registry.load_benchmark()
        cell = pb_registry.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {seen}", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"perfbench: the port is not in {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    info = out.pop("_info")
    print(f"perfbench: {cell.name} seed {args.seed}: {json.dumps(info)}",
          file=sys.stderr)
    for line in check_lines(out):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
