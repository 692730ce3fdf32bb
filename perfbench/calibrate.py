"""The readings the check's limit is set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --first-seed <n> \\
        --seeds 12 --control-seeds 3

For each seed: one grid of the cell's own shape, made as a run makes its
window's grids, is dispatched and collected through the port's
``dispatch_sweep``; the lanes a run would check (``pb_check.sample_lanes``)
are simulated again by the plain reference as one batch, as a run does,
and the port's rows are compared with the reference's (the lower readings
of the check's numbers, ``pb_check.compare_rows``: what sound runs of the
program give). For the first ``--control-seeds`` seeds the control runs on
the same lanes too: the reference with its float32 state rounded to
bfloat16 after every tick, compared with the float32 reference (the upper
readings). The reference jobs run in a pool of worker processes
(``--workers``) while the card runs the next grids. One JSON line a seed,
then a summary line; both give the readings per scenario of the grid too,
with the port's ``async_frac`` and ``views`` under Sporades.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import pb_check  # noqa: E402
import pb_inputs  # noqa: E402
import pb_registry  # noqa: E402
import run  # noqa: E402


def reading(pairs) -> dict:
    """The check's numbers over (row, reference row) pairs."""
    out = {"exact_mismatches": 0, "max_ulps": 0, "paths": {}}
    for row, ref in pairs:
        one = pb_check.compare_rows(row, ref)
        out["exact_mismatches"] += one["exact_mismatches"]
        out["max_ulps"] = max(out["max_ulps"], one["max_ulps"])
        for k, v in one["paths"].items():
            out["paths"][k] = out["paths"].get(k, 0) + v
    return out


def by_scenario(g, lanes, pairs) -> dict:
    """``reading`` per scenario over the (row, reference row) pairs of
    ``lanes`` of grid ``g``, with the rows' ``async_frac`` and ``views``
    where they have them."""
    out: dict = {}
    for lane, (row, ref) in zip(lanes, pairs):
        name = str(g.scenarios[g.points[lane][2]])
        one = out.setdefault(name, {"pairs": [], "async_frac": [],
                                    "views": []})
        one["pairs"].append((row, ref))
        for k in ("async_frac", "views"):
            if k in row:
                one[k].append(row[k])
    return {name: dict(reading(v.pop("pairs")), **v)
            for name, v in out.items()}


def _worst(readings, pick) -> dict:
    return {k: pick(r[k] for r in readings)
            for k in ("exact_mismatches", "max_ulps")}


def _job(job: dict):
    return pb_check.reference_rows(**job)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = pb_registry.cell(pb_registry.load_benchmark(), args.workload)
    sys.path.insert(0, str(pb_registry.ROOT / "src"))
    port = run.Port(args.device)
    traffic, protocol = cell.traffic, cell.config["protocol"]
    settings = pb_inputs.smr_settings(cell.config, traffic)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    rows, picks, grids, futs = [], [], [], {}
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=args.workers,
                             mp_context=ctx) as pool:
        for i, seed in enumerate(seeds):
            g = pb_inputs.make_grid(settings, traffic, seed, 1)
            grids.append(g)
            rows.append(port.dispatch(protocol, settings, g).collect())
            lanes = pb_check.sample_lanes(seed, [g])[1]
            picks.append(lanes)
            for prec in ["float32"] + (["bfloat16"]
                                       if i < args.control_seeds else []):
                futs[(i, prec)] = pool.submit(_job, {
                    "protocol": protocol, "config": cell.config,
                    "traffic": traffic, "grid": g, "lanes": lanes,
                    "precision": prec})
        port_s = time.perf_counter() - t0
        got = {k: f.result() for k, f in futs.items()}
    ref_s = time.perf_counter() - t0
    lower, upper, scen_lower, scen_upper = [], [], {}, {}
    for i, seed in enumerate(seeds):
        ref = got[(i, "float32")]
        pairs = [(rows[i][lane], r) for lane, r in zip(picks[i], ref)]
        program = reading(pairs)
        line = {"seed": seed, "lanes": picks[i], "program": program,
                "program_by_scenario": by_scenario(grids[i], picks[i],
                                                   pairs)}
        lower.append(program)
        for name, r in line["program_by_scenario"].items():
            scen_lower.setdefault(name, []).append(r)
        if (i, "bfloat16") in got:
            cpairs = list(zip(got[(i, "bfloat16")], ref))
            control = reading(cpairs)
            line["control"] = control
            line["control_by_scenario"] = by_scenario(grids[i], picks[i],
                                                      cpairs)
            upper.append(control)
            for name, r in line["control_by_scenario"].items():
                scen_upper.setdefault(name, []).append(r)
        print(json.dumps(line, default=float), flush=True)
    print(json.dumps({"workload": cell.name,
                      "lower": _worst(lower, max),
                      "upper": _worst(upper, min) if upper else None,
                      "lower_by_scenario": {
                          k: dict(_worst(v, max),
                                  async_frac=[x for r in v
                                              for x in r["async_frac"]],
                                  views=[x for r in v for x in r["views"]])
                          for k, v in scen_lower.items()},
                      "upper_by_scenario": {k: _worst(v, min)
                                            for k, v in scen_upper.items()},
                      "seeds": len(seeds), "control_seeds": len(upper),
                      "port_s": port_s, "ref_s": ref_s,
                      "workers": args.workers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
