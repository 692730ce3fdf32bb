"""Benchmark run history: an append-only JSONL ledger + regression gate
(port of ``repro.obs.history``, the same schema).

One entry per benchmark or audit run in a ``BENCH_history.jsonl`` ledger:
git sha, wall-clock timestamp, quick flag, and per-suite timing and cache
stats plus a monitor-shaped verdict (``obs/monitor.py``; the graph audit's,
``analysis/graph_lint.append_history``). ``compare`` is the gate: a monitor
violation in the current entry **fails**, a >25% wall-clock regression vs
the previous entry **warns** — perf noise on shared runners is real,
consensus violations are not. Either package reads a ledger the other
wrote.

Everything here is stdlib-only on purpose: the gate must run even where
torch is broken.
"""
from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

# numeric per-suite stats copied verbatim into an entry (the reference's)
SUITE_STATS = ("wall_s", "compile_s", "run_s", "xla_compile_s",
               "cache_hits", "cache_misses", "cache_saved_s", "traces")


def git_sha(repo_root) -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             cwd=str(repo_root), capture_output=True,
                             text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except OSError:
        return "unknown"


def make_entry(suites: Dict[str, Dict], quick: bool,
               git_sha: str = "unknown", timestamp: float = 0.0) -> Dict:
    """One history entry from per-suite stat dicts. Copies the known
    numeric stats, the error marker, and the monitor verdict; ignores
    anything else so bookkeeping churn can't silently change the history
    schema."""
    out_suites: Dict[str, Dict] = {}
    for name, s in suites.items():
        row: Dict = {}
        for k in SUITE_STATS:
            if k in s and s[k] is not None:
                row[k] = round(float(s[k]), 6) if isinstance(
                    s[k], float) else s[k]
        if s.get("error"):
            row["error"] = str(s["error"])
        mon = s.get("monitor")
        if mon is not None:
            row["monitor"] = {"ok": bool(mon.get("ok", False)),
                              "violations": dict(mon.get("violations", {})),
                              "level": mon.get("level"),
                              "points": mon.get("points")}
        # static-analysis rule counts (the lint): active findings
        # per rule at the time of the run, so lint debt is a trajectory
        ana = s.get("analysis")
        if isinstance(ana, dict):
            row["analysis"] = {str(k): int(v) for k, v in ana.items()}
        out_suites[name] = row
    return {"schema": SCHEMA_VERSION, "git_sha": str(git_sha),
            "timestamp": float(timestamp), "quick": bool(quick),
            "suites": out_suites}


def validate_entry(entry: Dict) -> Dict:
    """Schema check; raises ValueError with a pointed message on the
    first violation, returns the entry unchanged otherwise."""
    if not isinstance(entry, dict):
        raise ValueError(f"history entry must be a dict, got {type(entry)}")
    for k in ("schema", "git_sha", "timestamp", "quick", "suites"):
        if k not in entry:
            raise ValueError(f"history entry missing {k!r}")
    if entry["schema"] != SCHEMA_VERSION:
        raise ValueError(f"history schema {entry['schema']!r} != "
                         f"{SCHEMA_VERSION}")
    if not isinstance(entry["suites"], dict) or not entry["suites"]:
        raise ValueError("history entry has no suites")
    for name, s in entry["suites"].items():
        if not isinstance(s, dict):
            raise ValueError(f"suite {name!r} entry must be a dict")
        if "error" not in s:
            if "wall_s" not in s:
                raise ValueError(f"suite {name!r} missing wall_s")
            if not isinstance(s["wall_s"], (int, float)) or s["wall_s"] < 0:
                raise ValueError(f"suite {name!r} wall_s {s['wall_s']!r}")
        mon = s.get("monitor")
        if mon is not None:
            if not isinstance(mon.get("ok"), bool):
                raise ValueError(f"suite {name!r} monitor.ok must be bool")
            if not isinstance(mon.get("violations"), dict):
                raise ValueError(
                    f"suite {name!r} monitor.violations must be a dict")
            if mon["ok"] and any(mon["violations"].values()):
                raise ValueError(
                    f"suite {name!r} monitor ok=True with violations")
        ana = s.get("analysis")
        if ana is not None:
            if not isinstance(ana, dict) or not all(
                    isinstance(v, int) for v in ana.values()):
                raise ValueError(f"suite {name!r} analysis block must "
                                 "map rule -> int count")
    return entry


def append(path, entry: Dict) -> None:
    validate_entry(entry)
    p = Path(path)
    with p.open("a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")


def load(path) -> List[Dict]:
    """All valid entries, oldest first; malformed lines are skipped (the
    ledger outlives schema bumps and interrupted writes)."""
    p = Path(path)
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(validate_entry(json.loads(line)))
        except (ValueError, json.JSONDecodeError):
            continue
    return out


def latest(path) -> Optional[Dict]:
    entries = load(path)
    return entries[-1] if entries else None


def compare(baseline: Optional[Dict], current: Dict,
            warn_frac: float = 0.25) -> Dict[str, Dict]:
    """Per-suite regression check of ``current`` against ``baseline``.
    Status per suite: ``fail`` (monitor violations — correctness),
    ``warn`` (wall-clock regressed by more than ``warn_frac``, or the
    suite errored), ``ok`` otherwise. Suites absent from the baseline
    compare against nothing and can only fail on their own monitor."""
    out: Dict[str, Dict] = {}
    base_suites = (baseline or {}).get("suites", {})
    for name, cur in current.get("suites", {}).items():
        row: Dict = {"status": "ok"}
        mon = cur.get("monitor")
        if mon is not None:
            row["monitor_ok"] = bool(mon["ok"])
            if not mon["ok"]:
                row["status"] = "fail"
                row["violations"] = dict(mon["violations"])
        if cur.get("error"):
            row["status"] = "fail" if row["status"] == "fail" else "warn"
            row["error"] = cur["error"]
        wall = cur.get("wall_s")
        base_wall = base_suites.get(name, {}).get("wall_s")
        if wall is not None:
            row["wall_s"] = wall
        if wall is not None and base_wall:
            row["base_wall_s"] = base_wall
            row["ratio"] = round(wall / base_wall, 4)
            if row["status"] == "ok" and wall > base_wall * (1 + warn_frac):
                row["status"] = "warn"
        out[name] = row
    return out


def format_compare(cmp: Dict[str, Dict]) -> List[str]:
    """Human lines for benchmark stderr / CI logs, one per suite."""
    lines = []
    for name, row in sorted(cmp.items()):
        bits = [f"{row['status'].upper():4}", name]
        if "ratio" in row:
            bits.append(f"wall {row['wall_s']:.2f}s "
                        f"({row['ratio']:.2f}x baseline)")
        elif "wall_s" in row:
            bits.append(f"wall {row['wall_s']:.2f}s (no baseline)")
        if "violations" in row:
            bits.append("violations " + " ".join(
                f"{k}={v}" for k, v in sorted(row["violations"].items())))
        if "error" in row:
            bits.append(f"error: {row['error']}")
        lines.append("  ".join(bits))
    return lines
