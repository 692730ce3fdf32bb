"""Findings, pragmas and baselines of the port's lint (a copy of
``repro.analysis.findings``, with the port's rule keys).

A finding is one rule violation at one source span. Suppression is
per-line and must be justified:

    # lint: allow(<rule-key>): <why this host-side code is intentional>

on the flagged line itself or on a comment line directly above it. A
pragma without a justification is itself a finding (rule ``pragma``) —
the suppression mechanism cannot silently grow blanket excludes.

Baselines (``--baseline``) are JSON lists of ``{rule, file, message}``
triples: findings already present in the baseline are reported as
``baselined`` and do not fail the run, so the pass can be introduced
against a repo with known debt and still gate *new* violations. Line
numbers are deliberately not part of the baseline key (edits above a
finding must not un-baseline it).

Stdlib-only on purpose: the lint runs in any Python, without torch.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

# rule keys (the pragma vocabulary). The reference's R3 (jit static
# args) has no counterpart without jit (lint.py's docstring says why); its
# HLO layer's H1-H4 have theirs in G1-G4 over the captured tick graph
# (graph_lint.py)
RULE_KEYS = {
    "R1": "host-sync",
    "R2": "dtype-hygiene",
    "R4": "drop-mask",
    "R5": "carry-hygiene",
    "P0": "pragma",
    "G1": "graph-f64",
    "G2": "graph-host-sync",
    "G3": "graph-loop",
    "G4": "graph-signature",
}
KEY_RULES = {v: k for k, v in RULE_KEYS.items()}

_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*allow\(\s*([\w-]+)\s*\)\s*(?::\s*(\S.*))?")
_ROOT_RE = re.compile(r"#\s*lint:\s*traced-root\b")


@dataclass
class Finding:
    """One rule violation at one span. ``pragma`` records how suppression
    resolved: ``none`` (active — fails the run), ``allowed`` (justified
    pragma on the span), ``baselined`` (known debt from --baseline)."""
    rule: str        # "R1", "R2", "R4", "R5" / "P0"
    key: str         # kebab rule key, the pragma vocabulary
    file: str        # repo-relative path
    line: int
    col: int
    severity: str    # "error" | "warn"
    message: str
    pragma: str = "none"

    @property
    def active(self) -> bool:
        return self.pragma == "none" and self.severity == "error"

    def span(self) -> str:
        return f"{self.file}:{self.line}:{self.col}"


@dataclass
class Pragma:
    key: str
    line: int                  # line the pragma suppresses
    justification: str = ""
    used: bool = False


class PragmaTable:
    """Per-file suppression table. A pragma on a *comment-only* line
    covers the next code line; an end-of-line pragma covers its own."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.by_line: Dict[Tuple[int, str], Pragma] = {}
        self.roots: List[int] = []     # `# lint: traced-root` marker lines
        self.unjustified: List[Pragma] = []
        lines = source.splitlines()
        for i, text in enumerate(lines, start=1):
            if _ROOT_RE.search(text):
                self.roots.append(i)
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            key, why = m.group(1), (m.group(2) or "").strip()
            target = i
            if text.lstrip().startswith("#"):
                # comment-only line: suppress the next non-comment line
                j = i
                while j < len(lines) and (not lines[j].strip()
                                          or lines[j].lstrip()
                                          .startswith("#")):
                    j += 1
                target = j + 1
            p = Pragma(key=key, line=target, justification=why)
            self.by_line[(target, key)] = p
            if not why:
                self.unjustified.append(p)

    def lookup(self, line: int, key: str) -> Optional[Pragma]:
        p = self.by_line.get((line, key))
        if p is not None:
            p.used = True
        return p

    def pragma_findings(self) -> List[Finding]:
        return [Finding(rule="P0", key="pragma", file=self.path,
                        line=p.line, col=0, severity="error",
                        message=f"pragma allow({p.key}) has no "
                                "justification — add `: <why>`")
                for p in self.unjustified]


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)

    def extend(self, fs: Iterable[Finding]) -> None:
        self.findings.extend(fs)

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if f.active]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.active:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def apply_baseline(self, baseline: List[dict]) -> None:
        known = {(b.get("rule"), b.get("file"), b.get("message"))
                 for b in baseline}
        for f in self.findings:
            if f.pragma == "none" and (f.rule, f.file, f.message) in known:
                f.pragma = "baselined"

    def to_json(self) -> List[dict]:
        return [asdict(f) for f in sorted(
            self.findings, key=lambda f: (f.file, f.line, f.rule))]

    def baseline_json(self) -> List[dict]:
        return [{"rule": f.rule, "file": f.file, "message": f.message}
                for f in sorted(self.active,
                                key=lambda f: (f.file, f.line, f.rule))]


def findings_from_json(data: List[dict]) -> List[Finding]:
    """Rehydrate a findings list written by ``Report.to_json`` (the
    ``--json`` artifact of ``python -m repro_torch.analysis``)."""
    fields = {"rule", "key", "file", "line", "col", "severity",
              "message", "pragma"}
    return [Finding(**{k: v for k, v in d.items() if k in fields})
            for d in data]


def load_baseline(path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    if not isinstance(data, list):
        raise ValueError(f"baseline {path} is not a JSON list")
    return data


def format_table(findings: List[Finding]) -> List[str]:
    """The findings table (rule, span, severity, pragma status, message)
    the CLI prints."""
    if not findings:
        return ["no findings"]
    rows = [("RULE", "WHERE", "SEV", "PRAGMA", "MESSAGE")]
    for f in sorted(findings, key=lambda f: (f.pragma != "none",
                                             f.file, f.line)):
        rows.append((f"{f.rule}/{f.key}", f.span(), f.severity,
                     f.pragma, f.message))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    return [" ".join(c.ljust(w) for c, w in zip(r[:4], widths))
            + " " + r[4] for r in rows]
