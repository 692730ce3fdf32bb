"""The paper's §5 in one script, through the PyTorch port: run
Mandator-Sporades and the baselines on the simulated 5-region WAN;
reproduce the Fig. 6 ordering and the Fig. 7 leader-crash recovery.

The counterpart of examples/wan_consensus_demo.py, on the CUDA card by
default (``--device cpu`` runs the plain PyTorch path on the CPU). Each
protocol's grid is one batched dispatch; on the card a run's tick is
captured once as a CUDA graph and replayed (repro_torch.core.
compile_cache). The paper tour dispatches its protocols together
(``run_sweeps``) and prints the same rows as one ``run_sweep`` each.

  PYTHONPATH=src python examples/torch_wan_consensus_demo.py

Scenario showcase — any adversary of the curated library
(repro_torch/scenarios/library.py), with the throughput timeline around
its windows:

  PYTHONPATH=src python examples/torch_wan_consensus_demo.py \\
      --scenario region-outage

Workload showcase — any traffic shape of the workload library
(repro_torch/workloads/library.py), region by region; composes with
--scenario:

  PYTHONPATH=src python examples/torch_wan_consensus_demo.py \\
      --workload closed-loop --scenario paper-ddos

Flight recorder — ``--trace out.json`` prints the per-phase latency
breakdown and writes a Chrome/Perfetto trace of the Mandator-Sporades
point:

  PYTHONPATH=src python examples/torch_wan_consensus_demo.py \\
      --trace ddos.json --scenario paper-ddos --rate 300000

The reference script's ``--no-compile-cache`` has no counterpart: the
port keeps no compile cache on disk. It captures each tick program once
per process and replays it for every run of the same shapes, so there is
nothing to seed or to turn off.

Each function returns the rows it printed, so that a caller can check
them; ``main(argv)`` returns what the chosen function returned.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs.smr import REGIONS, SMRConfig
from repro_torch.core.experiment import SweepSpec, run_sweeps
from repro_torch.obs import export
from repro_torch.scenarios import Crash, Scenario
from repro_torch.scenarios import library
from repro_torch.workloads import library as workload_library

# the paper tour's offered rate per protocol, near each one's saturation
TOUR_RATES = (("mandator-sporades", 400_000),
              ("mandator-paxos", 400_000),
              ("multipaxos", 100_000),
              ("epaxos", 10_000),
              ("rabia", 1_000))


def paper_tour(sim_s: float = 3.0, crash_s: float = 1.5,
               crash_rate: float = 100_000, device=None) -> dict:
    """Fig. 6's saturation points and Fig. 7's leader crash at
    ``crash_s``. Returns {"tour": {protocol: row}, "crash": {protocol:
    row}}."""
    cfg = SMRConfig(sim_seconds=sim_s)
    print("== best-case WAN (5 regions: Virginia, Ireland, Mumbai, "
          "São Paulo, Tokyo) ==")
    rows = run_sweeps([(proto, cfg, SweepSpec(rates=(rate,)))
                       for proto, rate in TOUR_RATES], device=device)
    tour = {}
    for (proto, _), (r,) in zip(TOUR_RATES, rows):
        tour[proto] = r
        print(f" {proto:20s} saturation ~{r['throughput']:8.0f} tx/s "
              f"@ {r['median_ms']:6.0f} ms median")

    print(f"\n== leader crash at t={crash_s}s (Fig. 7) ==")
    spec = SweepSpec(rates=(crash_rate,),
                     scenarios=(Scenario("leader-crash",
                                         (Crash(start_s=crash_s,
                                                targets=(0,)),)),))
    protos = ("mandator-sporades", "mandator-paxos")
    rows = run_sweeps([(proto, cfg, spec) for proto in protos],
                      device=device)
    crash = {}
    for proto, (r,) in zip(protos, rows):
        crash[proto] = r
        tl = "|".join(f"{x/1000:.0f}k" for x in r["timeline"])
        print(f" {proto:20s} [{tl}] tx/s per 500ms")
    return {"tour": tour, "crash": crash}


def scenario_showcase(name: str, sim_s: float = 4.0, rate: float = 100_000,
                      device=None) -> dict:
    """One adversary of the library on three protocols, each row's
    timeline with the adversity windows marked. Returns {protocol:
    row}."""
    cfg = SMRConfig(sim_seconds=sim_s)
    scen = library.get(name, sim_s, cfg.n_replicas)
    windows = [(getattr(ev, "start_s", getattr(ev, "at_s", 0.0)),
                getattr(ev, "end_s", float("inf")), type(ev).__name__)
               for ev in scen.events]
    print(f"== scenario {name!r} on the 5-region WAN "
          f"({sim_s:.0f}s sim, {rate:,.0f} tx/s offered) ==")
    for s, e, kind in windows:
        end = f"{min(e, sim_s):.2f}s" if e != float("inf") else "end"
        print(f"  {kind:17s} {s:.2f}s -> {end}")
    spec = SweepSpec(rates=(rate,), scenarios=(scen,))
    protos = ("mandator-sporades", "mandator-paxos", "multipaxos")
    out = {}
    for proto, (r,) in zip(protos, run_sweeps(
            [(proto, cfg, spec) for proto in protos], device=device)):
        out[proto] = r
        print(f"\n {proto}: {r['throughput']:,.0f} tx/s overall, "
              f"median {r['median_ms']:.0f} ms")
        tl = np.asarray(r["timeline"])
        bucket_s = sim_s / len(tl)
        marks = "".join(
            "#" if any(s <= (b + 0.5) * bucket_s < min(e, sim_s)
                       for s, e, _ in windows) else "."
            for b in range(len(tl)))
        print(f"   window  [{marks}]  (# = adversity active)")
        print("   tx/s    [" + "|".join(f"{x/1000:.0f}k" for x in tl) + "]"
              f"  per {bucket_s * 1000:.0f}ms bucket")
    return out


def workload_showcase(wname: str, sname: str = "", sim_s: float = 4.0,
                      rate: float = 100_000, device=None) -> dict:
    """Per-region view of a traffic shape (optionally under an adversary):
    who commits how much, and where the latency is paid. Returns
    {protocol: row}."""
    cfg = SMRConfig(sim_seconds=sim_s)
    n = cfg.n_replicas
    wl = workload_library.get(wname, sim_s, n)
    scen = library.get(sname, sim_s, n) if sname else None
    closed = any(type(s).__name__ == "ClosedLoop" for s in wl.shapes)
    print(f"== workload {wname!r}"
          + (f" under scenario {sname!r}" if sname else "")
          + f" ({sim_s:.0f}s sim, {rate:,.0f} tx/s "
          + ("client-pool target" if closed else "offered") + ") ==")
    spec = SweepSpec(rates=(rate,), scenarios=(scen,), workloads=(wl,))
    protos = ("mandator-sporades", "mandator-paxos")
    out = {}
    for proto, (r,) in zip(protos, run_sweeps(
            [(proto, cfg, spec) for proto in protos], device=device)):
        out[proto] = r
        print(f"\n {proto}: {r['throughput']:,.0f} tx/s overall, "
              f"median {r['median_ms']:.0f} ms, p99 {r['p99_ms']:.0f} ms")
        lat_tl = np.asarray(r["origin_lat_ms_timeline"])   # [n, buckets]
        tl = np.asarray(r["origin_timeline"])
        bucket_s = sim_s / lat_tl.shape[1]
        med = np.asarray(r["origin_median_ms"])
        p99 = np.asarray(r["origin_p99_ms"])
        infl = r.get("inflight_max")
        for i in range(n):
            cells = "|".join("   ." if not np.isfinite(x) else f"{x:4.0f}"
                             for x in lat_tl[i])
            extra = f"  max in-flight {infl[i]:5.0f}" if infl is not None \
                else ""
            print(f"   {REGIONS[i][:8]:8s} med {med[i]:6.0f} ms  "
                  f"p99 {p99[i]:6.0f} ms  share "
                  f"{tl[i].sum() / max(tl.sum(), 1e-9):5.1%}{extra}")
            print(f"            lat/ms  [{cells}]  per "
                  f"{bucket_s * 1000:.0f}ms bucket")
    return out


def traced_run(trace_path: str, sname: str = "", wname: str = "",
               sim_s: float = 4.0, rate: float = 100_000,
               device=None) -> dict:
    """Flight-recorder view of one point (composes with --scenario /
    --workload): per-phase latency tables for the Mandator protocols plus
    a Perfetto trace of the Mandator-Sporades run. Returns {protocol:
    row, "trace": the path written}."""
    cfg = SMRConfig(sim_seconds=sim_s, trace_level="full")
    scen = library.get(sname, sim_s, cfg.n_replicas) if sname else None
    wl = workload_library.get(wname, sim_s, cfg.n_replicas) if wname \
        else None
    print(f"== flight recorder @ {rate:,.0f} tx/s"
          + (f", scenario {sname!r}" if sname else "")
          + (f", workload {wname!r}" if wname else "")
          + f" ({sim_s:.0f}s sim) ==")
    spec = SweepSpec(rates=(rate,), scenarios=(scen,), workloads=(wl,))
    protos = ("mandator-sporades", "mandator-paxos")
    out = {}
    for proto, (r,) in zip(protos, run_sweeps(
            [(proto, cfg, spec) for proto in protos], device=device)):
        out[proto] = r
        print(f"\n {proto}: {r['throughput']:,.0f} tx/s, "
              f"median {r['median_ms']:.0f} ms")
        print(export.phase_table(r))
        if proto == "mandator-sporades":
            p = export.write(trace_path,
                             export.chrome_trace(r, cfg, proto,
                                                 scenario=scen))
            out["trace"] = p
            print(f"\n# wrote {p} — open at https://ui.perfetto.dev")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="",
                    help=f"showcase one of: {', '.join(library.NAMES)}")
    ap.add_argument("--workload", default="",
                    help="per-region latency view of one of: "
                         f"{', '.join(workload_library.NAMES)} "
                         "(composes with --scenario)")
    ap.add_argument("--sim-seconds", type=float, default=4.0)
    ap.add_argument("--rate", type=float, default=100_000)
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="run the flight recorder: write a Chrome/Perfetto "
                         "trace of the (--scenario/--workload-composed) "
                         "point here and print the per-phase latency table")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.trace:
        return traced_run(args.trace, args.scenario, args.workload,
                          args.sim_seconds, args.rate, device=args.device)
    if args.workload:
        return workload_showcase(args.workload, args.scenario,
                                 args.sim_seconds, args.rate,
                                 device=args.device)
    if args.scenario:
        return scenario_showcase(args.scenario, args.sim_seconds, args.rate,
                                 device=args.device)
    return paper_tour(device=args.device)


if __name__ == "__main__":
    main()
