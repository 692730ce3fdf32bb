#!/usr/bin/env python3
"""The device timeline of a benchmark cell's grid boundaries, span by
span, over one untraced run on one card.

    python3 tools/boundary_events.py --workload CELL --seed N \\
        [--seconds S] [--root DIR] [--out PATH]

Runs the cell as ``perfbench/run.py`` does (``run.run_cell``, in this
process) from the checkout at ``--root`` (this one by default), with
every per-grid span of the sweep engine (``core/spans.py``: the
``sweep.*`` and ``collect.*`` spans) also recording a CUDA event on the
current stream at its entry and its exit. The device time between two
events is what the device ran, or waited for on the host, between those
two host points. A boundary runs from a grid's ``sweep.enqueue`` exit
(its last replay) to the next grid's ``sweep.enqueue`` entry (its first
replay), as ``device.boundary_ms`` does.

Prints one JSON line (the run's metrics and each boundary's device ms)
and then the boundaries after the warm grid's, split into those that
hold a ``collect.readback`` and those that do not, with each kind's mean
device ms between consecutive events. ``--out`` keeps every event and
boundary as JSON. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

NAMES = ("sweep.lower", "sweep.arrivals", "sweep.tick0", "sweep.capture",
         "sweep.load", "sweep.enqueue", "sweep.finish", "collect.wait",
         "collect.readback", "collect.rows")


def boundaries(rows: list) -> list:
    """Each boundary's device ms and its segments: ``rows`` are (span,
    "in"/"out", device ms, host ms) in host order."""
    ends = [i for i, r in enumerate(rows)
            if r[:2] == ("sweep.enqueue", "out")]
    starts = [i for i, r in enumerate(rows)
              if r[:2] == ("sweep.enqueue", "in")]
    out = []
    for i in ends:
        j = next((j for j in starts if j > i), None)
        if j is None:
            continue
        seg: dict = {}
        for a, b in zip(rows[i:j], rows[i + 1:j + 1]):
            key = f"{a[0]}:{a[1]} -> {b[0]}:{b[1]}"
            seg[key] = seg.get(key, 0.0) + (b[2] - a[2])
        out.append({"device_ms": rows[j][2] - rows[i][2],
                    "host_ms": rows[j][3] - rows[i][3],
                    "readback": any("collect.readback" in k for k in seg),
                    "segments": seg})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    out = args.out.resolve() if args.out else None
    root = args.root.resolve()
    sys.path[:0] = [str(root / "perfbench"), str(root / "src")]
    os.chdir(root)
    import torch
    import pb_registry
    import run as pb_run
    from repro_torch.core import spans

    log = []

    class event_span(spans.span):
        __slots__ = ()

        def _record(self, what):
            if (self.name in NAMES and torch.cuda.is_initialized()
                    and not torch.cuda.is_current_stream_capturing()):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream())
                log.append((self.name, what, ev, time.perf_counter()))

        def __enter__(self):
            self._record("in")
            return super().__enter__()

        def __exit__(self, *exc):
            done = super().__exit__(*exc)
            self._record("out")
            return done

    spans.span = event_span
    pb_run.set_cache_dirs()
    cell = pb_registry.cell(pb_registry.load_benchmark(), args.workload)
    res = pb_run.run_cell(cell, args.seed, args.seconds, False)
    torch.cuda.synchronize()
    ev0, host0 = log[0][2], log[0][3]
    rows = [(name, what, ev0.elapsed_time(ev), (host - host0) * 1e3)
            for name, what, ev, host in log]
    bounds = boundaries(rows)
    metrics = {k: v["value"] for k, v in res.get("metrics", {}).items()}
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "cell": cell.name, "seed": args.seed, "root": str(root),
            "metrics": metrics, "boundaries": bounds, "events": rows}))
    print(json.dumps({"metrics": metrics, "boundary_device_ms": [
        b["device_ms"] for b in bounds]}))
    for kind in (True, False):
        some = [b for b in bounds[1:] if b["readback"] is kind]
        if not some:
            continue
        print(f"{'with' if kind else 'without'} readback: {len(some)} "
              f"boundaries, device ms {[b['device_ms'] for b in some]}")
        keys = dict.fromkeys(k for b in some for k in b["segments"])
        for k in keys:
            ms = statistics.mean(b["segments"].get(k, 0.0) for b in some)
            print(f"  {ms:10.3f} ms  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
