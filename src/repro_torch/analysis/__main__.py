"""The port's lint CLI.

  PYTHONPATH=src python -m repro_torch.analysis \\
      [--rules R1,R4,...] [--baseline baseline.json] [--json findings.json]
      [--graph [--device cuda] [--sim-seconds 2.0]
               [--graph-history BENCH_history.jsonl]]

Exit codes: 0 clean (active findings == 0), 1 findings, 2 internal
error. ``--graph`` also audits the captured tick program of every scan
protocol (``graph_lint.py``, G1-G4, the counterpart of the reference's
``--hlo``): on the CPU by default (G1, G2 and the host sides of G3 and
G4), on the card with ``--device cuda`` (the captures too), appending the
verdict to the benchmark history ledger when ``--graph-history`` names a
path (the counterpart of ``--hlo-history``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import (KEY_RULES, format_table,
                                           load_baseline)
from repro_torch.analysis.lint import ALL_RULES, run_lint


def _parse_rules(spec: str):
    rules = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        rule = tok.upper() if tok.upper() in ALL_RULES \
            else KEY_RULES.get(tok.lower())
        if rule not in ALL_RULES:
            sys.exit(f"unknown rule {tok!r}; valid: "
                     f"{', '.join(ALL_RULES)} (or their kebab keys)")
        rules.append(rule)
    return tuple(rules)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's AST lint (R1 host-sync, R2 dtype-hygiene, "
                    "R4 drop-mask, R5 carry-hygiene) and its audit of "
                    "the captured tick program (G1-G4)")
    ap.add_argument("--root", default=None,
                    help="source tree to lint (default: the "
                         "src/repro_torch this module was imported from)")
    ap.add_argument("--rules", default="",
                    help="comma list of rules to run, e.g. R1,R4 or "
                         "host-sync,drop-mask (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="JSON list of known findings that do not fail "
                         "the run (see findings.py)")
    ap.add_argument("--update-baseline", default=None,
                    help="write the current active findings as a new "
                         "baseline JSON and exit 0")
    ap.add_argument("--json", default=None,
                    help="write the full findings list (including "
                         "allowed/baselined) as JSON")
    ap.add_argument("--graph", action="store_true",
                    help="also audit each scan protocol's captured tick "
                         "program (G1-G4)")
    ap.add_argument("--device", default="cpu",
                    help="device of the --graph audit (default cpu; cuda "
                         "captures and replays the programs)")
    ap.add_argument("--graph-history", default=None,
                    help="append the --graph audit's verdict to this "
                         "BENCH_history.jsonl ledger")
    ap.add_argument("--sim-seconds", type=float, default=2.0,
                    help="sweep length of the --graph audit")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else Path(__file__).parents[1]
    rules = _parse_rules(args.rules) or None
    try:
        report = run_lint(root, rules=rules)
    except SyntaxError as e:
        print(f"error: cannot parse {e.filename}:{e.lineno}: {e.msg}",
              file=sys.stderr)
        return 2

    verdict = None
    if args.graph:
        from repro_torch.analysis import graph_lint
        try:
            verdict = graph_lint.audit(report=report,
                                       sim_seconds=args.sim_seconds,
                                       device=args.device)
        except Exception as e:  # noqa: BLE001 — exit 2, not a traceback
            print(f"error: graph audit failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        if not args.quiet:
            print(graph_lint.format_verdict(verdict))

    if args.baseline:
        report.apply_baseline(load_baseline(args.baseline))
    if verdict is not None and args.graph_history:
        from repro_torch.analysis import graph_lint
        counts = {"active": len(report.active)}
        counts.update(report.counts())
        graph_lint.append_history(args.graph_history, verdict,
                                  analysis_counts=counts)
    if args.update_baseline:
        Path(args.update_baseline).write_text(
            json.dumps(report.baseline_json(), indent=1) + "\n")
        print(f"wrote baseline: {args.update_baseline} "
              f"({len(report.baseline_json())} findings)")
        return 0
    if args.json:
        Path(args.json).write_text(
            json.dumps(report.to_json(), indent=1) + "\n")

    active = report.active
    if not args.quiet:
        shown = [f for f in report.findings
                 if f.pragma != "none" or f.active]
        for line in format_table(shown):
            print(line)
        counts = ", ".join(f"{r}={n}"
                           for r, n in sorted(report.counts().items()))
        print(f"\n{len(active)} active finding(s)"
              + (f" ({counts})" if counts else "")
              + f"; {sum(1 for f in report.findings if f.pragma == 'allowed')}"
                " allowed by pragma, "
              + f"{sum(1 for f in report.findings if f.pragma == 'baselined')}"
                " baselined")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
