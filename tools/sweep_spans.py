#!/usr/bin/env python3
"""Where a grid's host and device time goes, from the port's own spans,
over one run of a benchmark cell on one card.

    python3 tools/sweep_spans.py --workload CELL --seed N [--seconds S] \\
        [--trace 0|1] [--out PATH]

Runs the cell as ``perfbench/run.py`` does (``run.run_cell``, in this
process), and reads the port's grid table (``core/spans.py``) as the
readers do (``pb_spans.window_grids``) and, with ``--trace 1``, the
profiler of the traced boundary after the window, kept as
``pb_trace.from_profiler`` is handed it. Prints one JSON object (and
writes it to ``--out``):

* ``result``: the run's result line and its ``_info``;
* ``window``: per span name, the window's grids that ran it and its total
  and self ms a grid; the window's counters summed (bytes read back,
  lanes, the device events' replay and boundary ms);
* ``grids``: each grid's total ms per span, in dispatch order: the warm
  one, the window's, then (``--trace 1``) the traced boundary's two;
* ``rates``: the window's lane-ticks per second over its wall time and
  over the device's replay and boundary time by CUDA events (the
  boundaries between the window's grids);
* ``traced`` (``--trace 1``): the device work each tick scope of grid
  k+1's eager tick 0 launched (busy ms, kernels, copies; matched through
  the launching runtime calls' correlation ids), the same for
  ``sweep.tick0`` as a whole, the spans' own device ranges found among
  the timeline's kernels (0: the existing readers see none), and the
  traced boundary's idle gaps named by the innermost span open on the
  host;
* ``span_cost_ns``: one span's host cost with no profiler on, and the
  window's spans per grid.

Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COST_SPANS = 200_000


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "perfbench"))
    sys.path.insert(0, str(ROOT / "src"))
    import pb_inputs
    import pb_registry
    import pb_spans
    import pb_trace
    import run as pb_run
    from repro_torch.core import spans
    pb_run.set_cache_dirs()
    cell = pb_registry.cell(pb_registry.load_benchmark(), args.workload)

    profs, timelines = [], []
    from_profiler = pb_trace.from_profiler

    def kept_profiler(prof):
        profs.append(prof)
        timelines.append(from_profiler(prof))
        return timelines[-1]
    pb_trace.from_profiler = kept_profiler
    try:
        out = pb_run.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    finally:
        pb_trace.from_profiler = from_profiler
    # the one place this tool leans on run_cell's course: a traced run
    # profiles one boundary
    assert len(profs) == (1 if args.trace else 0), len(profs)

    info = out["_info"]
    window = pb_spans.window_grids({})
    assert len(window) == info["grids"], (len(window), info["grids"])
    c = {}
    for g in window:
        for k, v in g["counters"].items():
            c[k] = c.get(k, 0) + v
    ticks = pb_inputs.sim_ticks(pb_inputs.smr_settings(cell.config,
                                                       cell.traffic))
    lane_ticks = c.get("collect.lanes", 0) * ticks
    # the window's boundaries only: the first grid's opens from the warm one
    device_ms = c.get("device.replay_ms", 0) + sum(
        g["counters"]["device.boundary_ms"] for g in pb_spans.inner(window))
    parents = {k: v["parent"] for k, v in spans.stats()["spans"].items()}
    report = {
        "card": card(), "cell": cell.name, "seed": args.seed,
        "result": out,
        "window": {"spans": pb_spans.summary(window, parents),
                   "counters": c, "grids": len(window)},
        "rates": {"lane_ticks": lane_ticks, "wall_s": info["wall_s"],
                  "per_wall_s": lane_ticks / info["wall_s"],
                  "device_s": device_ms / 1e3,
                  "per_device_s": lane_ticks / (device_ms / 1e3)
                  if device_ms else None}}
    report["grids"] = [{k: ns / 1e6 for k, ns in g["ns"].items()}
                       for g in spans.grids()]
    if profs:
        events = profs[0].events()
        t0 = pb_spans.scope_kernels(events, "sweep.tick0")
        tl = timelines[0]
        report["traced"] = {
            "tick_scopes": pb_spans.scope_split(events),
            "tick0": {"busy_ms": pb_trace.busy_us(t0, t0[0][0], t0[-1][1])
                      / 1e3 if t0 else None,
                      "kernels": sum(1 for x in t0 if x[3]),
                      "copies": sum(1 for x in t0 if not x[3])},
            "span_events_in_timeline": sum(
                1 for x in (tl.events if tl else [])
                if x[2].startswith(pb_spans.PREFIXES)),
            "named_gaps": pb_spans.named_gaps(
                tl, pb_spans.host_spans(events)) if tl else None}

    spans_per_grid = sum(len(g["ns"]) for g in window) / max(len(window), 1)
    t = time.perf_counter_ns()
    for _ in range(COST_SPANS):
        with spans.span("cost.probe"):
            pass
    per_span = (time.perf_counter_ns() - t) / COST_SPANS
    report["span_cost_ns"] = {"per_span": per_span,
                              "spans_per_grid": spans_per_grid,
                              "ms_per_grid": per_span * spans_per_grid
                              / 1e6}
    line = json.dumps(report, default=str)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
