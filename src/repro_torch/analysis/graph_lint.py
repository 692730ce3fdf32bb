"""The port's program auditor: the captured tick (counterpart of
``repro.analysis.hlo_lint``).

The reference lowers each scan protocol's canonical sweep program and
asserts over its optimized HLO (H1-H4). The port's program is one tick
captured as a CUDA graph and replayed (``core/compile_cache.py``); this
audit asserts over that tick, through ``distributed/graph_analysis.py``:

  G1 graph-f64          no float64 op in a tick, beyond those the source
                        justifies: an op with a float64 output must come
                        from a line (or statement) that carries a
                        ``# lint: allow(dtype-hygiene): <why>`` pragma,
                        as R2 asks of the source
  G2 graph-host-sync    no host transfer in a tick (``graph_analysis.
                        host_transfer_ops``: a scalar read back, an
                        output sized by the data, a tensor made from host
                        data, a copy between devices). On the card, the
                        tick captures (a capture fails on any of them)
  G3 graph-loop         one capture per point: the loop runs its warm-up
                        tick eagerly and then ``n_ticks - 1`` replays and
                        nothing else (``compile_cache.stats()``), and the
                        channel-ring kernels' ``launch_count`` moves only
                        for the warm-up and the capture, never during the
                        replays. On the CPU (no graph), the host side:
                        every carry leaf keeps its shape and dtype from
                        one tick to the next (what the graph's copy-back
                        needs) and the run is counted eager, with no
                        capture
  G4 graph-signature    every point of the audit grid lowers to ONE
                        ``ProgramSignature`` per workload mode (the
                        combined grid to the same one but for its lane
                        count), and a second sweep with an equal signature
                        captures nothing: on the host, two such sweeps
                        have one program key (``harness.program_key``); on
                        the card, the second captures 0

G1, G2 and the host sides of G3 and G4 run on the CPU; ``device="cuda"``
adds the captures, replays and launch counts. The analytic protocols
(epaxos, rabia) have no device program and are vacuously clean. The
verdict is shaped like an ``obs/monitor.py`` verdict (``ok`` /
``violations`` / ``level`` / ``points``), as the reference's, and
``append_history`` lands it in the ``BENCH_history.jsonl`` ledger
(``obs/history.py``) as a ``graph-audit`` suite: a suite of its own, so
that ``history.compare`` never sets a graph audit's wall against the
reference's ``hlo-audit`` in a ledger both packages write.
"""
from __future__ import annotations

import ast
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.findings import (Finding, PragmaTable, Report,
                                           RULE_KEYS)

AUDIT_SCENARIOS = (None, "leader-crash-recover", "symmetric-partition")
AUDIT_RATES = (50_000.0, 300_000.0)
AUDIT_WORKLOAD = "onoff-burst"   # windowed, canonical width

_PORT = Path(__file__).resolve().parents[1]


def _emit(report: Optional[Report], rule: str, where: str,
          message: str) -> None:
    if report is not None:
        report.findings.append(Finding(
            rule=rule, key=RULE_KEYS[rule], file=where, line=0, col=0,
            severity="error", message=message))


class _Justified:
    """Whether a source line's float64 is justified: a ``dtype-hygiene``
    pragma with its reason on the line or on the first line of the
    statement holding it (the lint's own reading, ``analysis/lint.py``)."""

    def __init__(self):
        self._files: Dict[str, tuple] = {}

    def _file(self, rel: str):
        if rel not in self._files:
            src = (_PORT / rel).read_text()
            stmts = [(n.lineno, n.end_lineno) for n in
                     ast.walk(ast.parse(src)) if isinstance(n, ast.stmt)]
            self._files[rel] = (PragmaTable(src, rel), stmts)
        return self._files[rel]

    def __call__(self, site) -> bool:
        if site is None:
            return False
        rel, line = site
        table, stmts = self._file(rel)
        firsts = [a for a, b in stmts if a <= line <= b]
        for ln in [line] + ([max(firsts)] if firsts else []):
            p = table.by_line.get((ln, RULE_KEYS["R2"]))
            if p is not None and p.justification:
                return True
        return False


def _grid(cfg, sim_seconds: float, workload: Optional[str]):
    """The audit grid's single-point specs and its combined spec."""
    from repro_torch.core.experiment import SweepSpec
    from repro_torch.scenarios import library as scenario_library
    from repro_torch.workloads import library as workload_library
    n = cfg.n_replicas
    scens = [scenario_library.get(s, sim_seconds, n) if s else None
             for s in AUDIT_SCENARIOS]
    wl = workload_library.get(workload, sim_seconds, n) if workload \
        else None
    singles = [(f"{name or 'baseline'}@{rate:.0f}",
                SweepSpec(rates=(rate,), scenarios=(scen,), workloads=(wl,)))
               for scen, name in zip(scens, AUDIT_SCENARIOS)
               for rate in AUDIT_RATES]
    combined = SweepSpec(rates=AUDIT_RATES, scenarios=tuple(scens),
                         workloads=(wl,))
    return singles, combined


def _inputs(protocol: str, cfg, spec, dev):
    """A sweep's run inputs, as ``experiment.dispatch_sweep`` builds them:
    (resolved cfg, n_ticks, env, arrivals, lanes)."""
    from repro_torch.core import experiment, harness, netsim
    _, rcfg, mode, env, rate_b, seeds = experiment._lower(
        cfg, spec, dev, canonical=True)
    arr = harness.make_arrivals(
        rcfg, mode, rate_b.tolist(), seeds, dev,
        experiment._lower_workloads(rcfg, spec, canonical=True))
    return rcfg, netsim.sim_ticks(rcfg), env, arr, len(seeds)


def _tree_key(tree):
    from repro_torch.core import harness
    return harness._tree_key(tree)


def _loop_on_cpu(protocol: str, cfg, spec, dev) -> List[str]:
    """G3's host side: a few eager ticks keep every carry leaf's shape and
    dtype, and the accounting counts them eager, with no capture."""
    from repro_torch.core import compile_cache, harness
    rcfg, _, env, arr, lanes = _inputs(protocol, cfg, spec, dev)
    ticks = 4
    run = harness._setup(protocol, rcfg, ticks, env, arr, lanes, dev)
    problems = []
    harness._warm(run, protocol, rcfg)
    keys = [_tree_key(run["carry"])]
    for _ in range(ticks - 1):
        harness._warm(run, protocol, rcfg)
        keys.append(_tree_key(run["carry"]))
    if any(k != keys[0] for k in keys[1:]):
        problems.append("a carry leaf changes its shape or dtype from one "
                        "tick to the next")
    before = compile_cache.stats()
    harness._scan_body(protocol, rcfg, ticks, env, arr, lanes, dev)
    d = compile_cache.delta(before)
    if d["captures"] or d["eager_runs"] != 1 or d["eager_ticks"] != ticks:
        problems.append(f"a CPU run of {ticks} ticks counted {d}")
    return problems


def _loop_on_card(protocol: str, cfg, spec, dev) -> tuple:
    """G3 on the card: one point run through ``harness._scan_body``;
    returns (problems, the accounting's delta, ring-kernel launches)."""
    import torch
    from repro_torch.core import compile_cache, harness
    from repro_torch.kernels.channel_ring import kernel as ring_kernel
    rcfg, n_ticks, env, arr, lanes = _inputs(protocol, cfg, spec, dev)
    rings = 1 if protocol in ("multipaxos", "mandator") else 2
    torch.cuda.synchronize()
    before, launches = compile_cache.stats(), ring_kernel.launch_count
    harness._scan_body(protocol, rcfg, n_ticks, env, arr, lanes, dev)
    torch.cuda.synchronize()
    d = compile_cache.delta(before)
    launches = ring_kernel.launch_count - launches
    problems = []
    if d["graph_runs"] != 1 or d["replays"] != n_ticks - 1 \
            or d["eager_ticks"] != 1 or d["captures"] > 1:
        problems.append(f"expected one graph run of {n_ticks - 1} replays "
                        f"after one eager tick, at most one capture: {d}")
    if launches != rings * (1 + d["captures"]):
        problems.append(f"{launches} channel_ring_commit launches through "
                        f"the wrapper, expected {rings} per eager or "
                        "captured tick and none during the replays")
    return problems, d, launches


def audit(protocols=None, sim_seconds: float = 2.0,
          report: Optional[Report] = None, device="cpu") -> Dict:
    """Run G1-G4 on ``device`` ("cpu": G1, G2 and the host sides of G3
    and G4; "cuda": the captures too). Returns the monitor-shaped verdict
    and appends one finding per violation to ``report``."""
    import torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import compile_cache, experiment, harness
    from repro_torch.distributed import graph_analysis as ga

    dev = torch.device(device)
    if protocols is None:
        protocols = harness.PROTOCOLS + experiment.ANALYTIC_PROTOCOLS
    cfg = SMRConfig(sim_seconds=sim_seconds)
    t0 = time.perf_counter()
    justified = _Justified()
    per: Dict[str, Dict] = {}
    tot = {"f64_ops": 0, "host_transfer_in_tick": 0, "graph_loop": 0,
           "signature_drift": 0}
    singles, combined = _grid(cfg, sim_seconds, AUDIT_WORKLOAD)
    variants = (("trivial", _grid(cfg, sim_seconds, None)[1], cfg),
                ("windowed", combined, cfg),
                ("telemetry-full", combined, dataclasses.replace(
                    cfg, trace_level="full", monitor_level="full")))

    for proto in protocols:
        if proto in experiment.ANALYTIC_PROTOCOLS:
            per[proto] = {"program": None,
                          "note": "host analytic model — no device "
                                  "program; vacuously clean"}
            continue
        where = f"<graph:{proto}>"
        f64 = f64_bad = 0
        transfers: List = []
        bad_sites = set()
        n_ops, dtypes = {}, {}
        for tag, spec, vcfg in variants:
            rcfg, n_ticks, env, arr, lanes = _inputs(proto, vcfg, spec, dev)
            ops = ga.tick_ops(proto, rcfg, n_ticks, env, arr, lanes, dev)
            n_ops[tag] = len(ops)
            dtypes[tag] = ga.dtype_op_counts(ops)
            for op in ops:
                if "f64" in op.dtypes:
                    f64 += 1
                    if not justified(op.site):
                        f64_bad += 1
                        bad_sites.add((op.name, op.site))
            transfers += [(tag, op) for op in ga.host_transfer_ops(ops)]
        if f64_bad:
            sites = ", ".join(f"{n} at {s[0]}:{s[1]}" if s else n
                              for n, s in sorted(bad_sites, key=str)[:4])
            _emit(report, "G1", where,
                  f"{f64_bad} float64 op(s) in the tick from lines no "
                  f"dtype-hygiene pragma justifies ({sites})")
        if transfers:
            ops = ", ".join(f"{op.name} ({tag}) at "
                            f"{op.site[0]}:{op.site[1]}" if op.site
                            else op.name for tag, op in transfers[:4])
            _emit(report, "G2", where,
                  f"{len(transfers)} host transfer(s) in the tick ({ops})"
                  " — a captured tick cannot hold one")
        loop = (_loop_on_card(proto, cfg, combined, dev) if dev.type ==
                "cuda" else (_loop_on_cpu(proto, cfg, combined, dev),
                             None, None))
        for msg in loop[0]:
            _emit(report, "G3", where, msg)
        tot["f64_ops"] += f64_bad
        tot["host_transfer_in_tick"] += len(transfers)
        tot["graph_loop"] += len(loop[0])
        per[proto] = {"f64_ops": f64, "f64_unjustified": f64_bad,
                      "host_transfers": len(transfers),
                      "loop_problems": len(loop[0]),
                      "ops_per_tick": n_ops, "dtype_ops": dtypes}
        if loop[1] is not None:
            per[proto].update(captures=loop[1]["captures"],
                              replays=loop[1]["replays"],
                              capture_s=loop[1]["capture_s"],
                              ring_launches=loop[2])

    # G4: one signature per workload mode across the grid; equal
    # signatures, one program
    drift: Dict[str, Dict] = {}
    scans = [p for p in protocols if p in harness.PROTOCOLS]
    for wl_name, tag in ((None, "trivial"), (AUDIT_WORKLOAD, "windowed")):
        pts, comb = _grid(cfg, sim_seconds, wl_name)
        sigs: Dict = {}
        for name, spec in pts:
            sigs.setdefault(experiment._signature(cfg, spec), []).append(
                name)
        csig = experiment._signature(cfg, comb)
        sigs.setdefault(dataclasses.replace(csig, lanes=1), []).append(
            "combined-grid")
        if len(sigs) != 1:
            detail = "; ".join(f"{s} <- {', '.join(p)}"
                               for s, p in sigs.items())
            _emit(report, "G4", f"<graph:grid:{tag}>",
                  f"{len(sigs)} distinct program signatures across the "
                  f"{tag} scenario x rate grid (expected 1): {detail}")
            tot["signature_drift"] += len(sigs) - 1
        (a_name, a), (b_name, b) = pts[0], pts[-1]
        same = {}
        for proto in scans:
            if dev.type == "cuda":
                experiment.run_sweep(proto, cfg, a, device=dev)
                before = compile_cache.stats()
                experiment.run_sweep(proto, cfg, b, device=dev)
                same[proto] = compile_cache.delta(before)["captures"] == 0
            else:
                keys = [harness.program_key(proto, *_inputs(proto, cfg, s,
                                                            dev), dev)
                        for s in (a, b)]
                same[proto] = keys[0] == keys[1]
            if not same[proto]:
                _emit(report, "G4", f"<graph:{proto}:{tag}>",
                      f"{b_name} has {a_name}'s signature but "
                      + ("captured a program of its own" if dev.type ==
                         "cuda" else "another program key"))
                tot["signature_drift"] += 1
        drift[tag] = {"signatures": {repr(s): p for s, p in sigs.items()},
                      "second_sweep_reuses": same}

    return {
        "ok": not any(tot.values()),
        "violations": {k: v for k, v in tot.items() if v},
        "level": "graph",
        "points": len(per),
        "protocols": per,
        "signatures": drift,
        "wall_s": round(time.perf_counter() - t0, 3),
        "sim_seconds": sim_seconds,
        "device": str(dev),
    }


def append_history(path, verdict: Dict, quick: bool = True,
                   analysis_counts: Optional[Dict[str, int]] = None) \
        -> None:
    """Land the audit verdict in the ``BENCH_history.jsonl`` ledger at
    ``path`` as a ``graph-audit`` suite entry: regressions then gate
    through ``history.compare`` exactly like runtime monitor
    violations."""
    from repro_torch.obs import history
    suite = {"wall_s": verdict["wall_s"], "monitor": verdict}
    if analysis_counts is not None:
        suite["analysis"] = dict(analysis_counts)
    repo = Path(path).resolve().parent
    entry = history.make_entry({"graph-audit": suite}, quick=quick,
                               git_sha=history.git_sha(repo),
                               timestamp=time.time())
    history.append(path, entry)


def format_verdict(v: Dict) -> str:
    head = "graph-audit OK" if v["ok"] else \
        f"graph-audit VIOLATIONS {v['violations']}"
    lines = [f"{head} ({v['points']} protocols, {v['wall_s']:.1f}s, "
             f"sim {v['sim_seconds']:.1f}s, {v['device']})"]
    for proto, d in v["protocols"].items():
        if d.get("program", "x") is None:
            lines.append(f"  {proto:18s} {d['note']}")
            continue
        line = (f"  {proto:18s} f64={d['f64_ops']} "
                f"(unjustified {d['f64_unjustified']}) "
                f"host_xfer_in_tick={d['host_transfers']} "
                f"loop_problems={d['loop_problems']} ops/tick="
                + "/".join(str(k) for k in d["ops_per_tick"].values()))
        if "captures" in d:
            line += (f" captures={d['captures']} replays={d['replays']} "
                     f"capture_s={d['capture_s']:.3f} "
                     f"ring_launches={d['ring_launches']}")
        lines.append(line)
    for tag, d in v["signatures"].items():
        reuse = ",".join(p for p, ok in d["second_sweep_reuses"].items()
                         if ok)
        lines.append(f"  grid[{tag}]: {len(d['signatures'])} signature(s);"
                     f" second sweep reuses the program: {reuse or 'none'}")
    return "\n".join(lines)
