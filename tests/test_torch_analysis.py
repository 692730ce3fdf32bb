"""The port's lint (repro_torch.analysis), on a corpus written here, one
file per rule with ``# expect: <RULE>`` on the line the rule must flag.

R4 (drop mask), R5 (carry hygiene), the pragma grammar, baselines and the
JSON report are the reference's stdlib-AST code: the same corpus, pragma
texts and baselines go through ``repro.analysis`` and must give the same
findings. R1 (host sync) and R2 (float64) match torch's forms, which the
reference's jnp/np patterns do not see, so they are held by the
``# expect:`` marks alone: each of R1, R2, R4 and R5 trips exactly once, a
justified pragma silences its span (one pragma covers a whole statement)
and an unjustified one is a finding; each host-sync form trips R1 once and
the forms that are no sync do not. The port's own source lints clean,
every suppression justified, and the CLI exits 0 and 1 and writes its
JSON artifact."""
import json
import re
from pathlib import Path

import pytest

from repro.analysis import findings as ref_findings
from repro.analysis import run_lint as ref_run_lint
from repro_torch.analysis import findings as port_findings
from repro_torch.analysis import format_table, run_lint
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.findings import (PragmaTable, findings_from_json,
                                           load_baseline)

SRC_PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
_EXPECT_RE = re.compile(r"#\s*expect:\s*(\w+)")

CORPUS = {
    "channel.py": '''
class Send:
    def __init__(self, name, payload):
        self.name, self.payload = name, payload


def ring_commit(spec, ring, t, sends, drop=None):
    return ring
''',
    "r1_bad.py": '''
import torch


def helper(x: torch.Tensor, t: int):
    tf = float(t)
    n = int(x.shape[0])
    y = x * tf + n
    if t % 2 and x is not None:
        y = y.float()
    return y.tolist()  # expect: R1


# lint: traced-root
def root(x: torch.Tensor, t: int):
    return helper(x, t)


def unreached(x: torch.Tensor):
    return float(x.sum())
''',
    "r2_bad.py": '''
import torch


def widen(x):
    return x.to(torch.float64)  # expect: R2
''',
    "r4_bad.py": '''
from corpus import channel as ch


def relay(ring, t, x):
    sends = [ch.Send("a", x)]
    return ch.ring_commit(None, ring, t, sends)  # expect: R4
''',
    "r5_bad.py": '''
def init_trace(level):
    return None


def make_state(level):
    st = {}
    st["tr"] = init_trace(level)  # expect: R5
    return st
''',
    "pragma_bad.py": '''
# lint: allow(dtype-hygiene)
def helper(x):  # expect: P0
    return x
''',
    "allowed.py": '''
from corpus import channel as ch


def init_monitor(level):
    return None


def relay(ring, t, x):
    sends = [ch.Send("a", x)]
    # lint: allow(drop-mask): a relay whose sends are never dropped
    return ch.ring_commit(None, ring, t, sends)


def make_state(level):
    st = {}
    st["mon"] = init_monitor(level)  # lint: allow(carry-hygiene): always on
    return st
''',
    "good.py": '''
import torch

from corpus import channel as ch


def init_trace(level):
    return None


def relay(ring, t, x, drop):
    sends = [ch.Send("a", x)]
    return ch.ring_commit(None, ring, t, sends, drop=drop)


def exact(x):
    # lint: allow(dtype-hygiene): a justified exception
    return x.double()


def exact_sum(x):
    # lint: allow(dtype-hygiene): one pragma covers the whole statement
    return torch.zeros(3, dtype=torch.float64
                       ).add_(x.double()).float()


def make_state(level):
    st = {}
    tr = init_trace(level)
    if tr is not None:
        st["tr"] = tr
    return st
''',
}


def _write(root: Path, files: dict) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    (root / "__init__.py").write_text("")
    for name, text in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_text(text.lstrip("\n"))
    return root


def _expected(root: Path) -> dict:
    """{(rule, file): line} from the corpus' ``# expect:`` markers."""
    out = {}
    for path in sorted(root.glob("*.py")):
        for lineno, text in enumerate(path.read_text().splitlines(), 1):
            m = _EXPECT_RE.search(text)
            if m:
                out[(m.group(1), path.name)] = lineno
    return out


@pytest.fixture
def corpus(tmp_path):
    return _write(tmp_path / "corpus", CORPUS)


def test_each_rule_trips_exactly_once(corpus):
    report = run_lint(corpus)
    expected = _expected(corpus)
    assert {r for r, _ in expected} == {"R1", "R2", "R4", "R5", "P0"}
    active = sorted((f.rule, Path(f.file).name, f.line)
                    for f in report.active)
    assert active == sorted((r, f, line)
                            for (r, f), line in expected.items()), active


def test_justified_pragma_silences_its_span(corpus):
    report = run_lint(corpus)
    good = [f for f in report.findings if Path(f.file).name == "good.py"]
    # exact_sum's statement spans lines 22-23, under one pragma
    assert sorted((f.rule, f.line, f.pragma) for f in good) == [
        ("R2", 17, "allowed"), ("R2", 22, "allowed"),
        ("R2", 23, "allowed")]
    allowed = [f for f in report.findings
               if Path(f.file).name == "allowed.py"]
    assert sorted((f.rule, f.pragma) for f in allowed) == [
        ("R4", "allowed"), ("R5", "allowed")]


def _spans(report):
    """A report's JSON without the messages, whose wording is the
    package's own."""
    return [{k: v for k, v in d.items() if k != "message"}
            for d in report.to_json()]


@pytest.mark.parametrize("rules", [("R4",), ("R5",), ("R4", "R5")])
def test_drop_mask_and_carry_hygiene_match_reference(corpus, rules):
    port = run_lint(corpus, rules=rules)
    assert _spans(port) == _spans(ref_run_lint(corpus, rules=rules))
    assert {f.rule for f in port.findings} == set(rules) | {"P0"}


PRAGMA_TEXTS = {
    "same-line": "x = 1  # lint: allow(drop-mask): same-line case\n",
    "comment-above": ("# lint: allow(host-sync): comment-above case\n"
                      "\n# another comment\ny = 2\n"),
    "unjustified": "# lint: allow(carry-hygiene)\nz = 3\n",
    "empty-why": "w = 4  # lint: allow( dtype-hygiene ):   \n",
    "traced-root": ("# lint: traced-root\ndef f():\n    pass\n"
                    "#lint:allow(pragma):spaces optional\nv = 5\n"),
    "trailing-comment": "# lint: allow(drop-mask): at the end of file\n",
}


def _table(mod, text):
    t = mod.PragmaTable(text, "t.py")
    found = {k: (p.line, p.justification)
             for k, p in t.by_line.items()}
    return (found, t.roots, [p.line for p in t.unjustified],
            [f.__dict__ for f in t.pragma_findings()])


@pytest.mark.parametrize("case", sorted(PRAGMA_TEXTS))
def test_pragma_table_matches_reference(case):
    text = PRAGMA_TEXTS[case]
    assert _table(port_findings, text) == _table(ref_findings, text)


def test_baseline_and_report_json_match_reference(tmp_path):
    rows = [("R4", "drop-mask", "a.py", 3, 4, "error", "m1", "none"),
            ("R5", "carry-hygiene", "a.py", 1, 0, "error", "m2", "none"),
            ("R2", "dtype-hygiene", "b.py", 9, 2, "error", "m3",
             "allowed"),
            ("P0", "pragma", "b.py", 2, 0, "warn", "m4", "none")]
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps([
        {"rule": "R4", "file": "a.py", "message": "m1"},
        {"rule": "R2", "file": "b.py", "message": "m3"},
        {"rule": "R5", "file": "c.py", "message": "m2"}, {}]))
    (tmp_path / "bad.json").write_text(json.dumps({"rule": "R4"}))
    out = []
    for mod in (port_findings, ref_findings):
        rep = mod.Report()
        rep.extend(mod.Finding(*r) for r in rows)
        before = (rep.to_json(), rep.baseline_json(), rep.counts())
        rep.apply_baseline(mod.load_baseline(base))
        with pytest.raises(ValueError):
            mod.load_baseline(tmp_path / "bad.json")
        back = [f.__dict__ for f in mod.findings_from_json(rep.to_json())]
        out.append((before, rep.to_json(), rep.baseline_json(),
                    rep.counts(), back, mod.format_table(rep.findings)))
    assert out[0] == out[1]
    assert [d["pragma"] for d in out[0][1]] == [
        "none", "baselined", "none", "allowed"]


def test_unjustified_pragma_is_a_finding(corpus):
    p0 = [f for f in run_lint(corpus).active if f.rule == "P0"]
    assert len(p0) == 1 and Path(p0[0].file).name == "pragma_bad.py"
    t = PragmaTable("x = 1  # lint: allow(drop-mask): same-line case\n"
                    "# lint: allow(host-sync): comment-above case\n"
                    "y = 2\n"
                    "# lint: allow(carry-hygiene)\n"
                    "z = 3\n", "t.py")
    assert t.lookup(1, "drop-mask").justification
    assert t.lookup(3, "host-sync").justification
    assert t.lookup(3, "drop-mask") is None
    assert [f.line for f in t.pragma_findings()] == [5]


def test_rule_subset_and_baseline(tmp_path, corpus):
    report = run_lint(corpus, rules=("R2",))
    assert {f.rule for f in report.active} == {"R2", "P0"}
    base = tmp_path / "baseline.json"
    full = run_lint(corpus)
    base.write_text(json.dumps(full.baseline_json()))
    fresh = run_lint(corpus)
    fresh.apply_baseline(load_baseline(base))
    assert fresh.active == []
    assert sum(f.pragma == "baselined" for f in fresh.findings) == \
        len(full.active)


# a tick-reachable function's body (the root is core/mandator.py's tick,
# found by name) -> whether R1 must flag it
SYNC_FORMS = {
    "item": ("return st['x'].item()", True),
    "tolist": ("return torch.zeros(3).tolist()", True),
    "cpu": ("return st['x'].cpu()", True),
    "numpy": ("return st['x'].numpy()", True),
    "float-of-tensor": ("return float(st['x'].sum())", True),
    "int-of-tensor": ("return int(torch.argmax(st['x']))", True),
    "bool-of-tensor": ("return bool((st['x'] > 0).any())", True),
    "if-tensor": ("if (st['x'] > 0).any():\n        return 1\n    "
                  "return 0", True),
    "while-tensor": ("y = st['x']\n    while y.sum() > 0:\n"
                     "        y = y - 1\n    return y", True),
    "print": ("print(t)\n    return t", True),
    "asarray-of-tensor": ("return np.asarray(st['x'] + 1)", True),
    "python-int-t": ("tf = float(t)\n    k = int(t % 7) + 1\n"
                     "    if t > 3 and k:\n        return tf * k\n"
                     "    return bool(t)", False),
    "tensor-methods": ("y = st['x'].float().clamp(min=0.0)\n"
                       "    return torch.where(y > 0, y, 0.0)", False),
    "identity-and-membership": ("if st.get('tr') is not None and 'm' in "
                                "st:\n        return 1\n    return 0",
                                False),
    "shapes": ("n = int(st['x'].shape[0])\n    if st['x'].dim() > 1:\n"
               "        return n\n    return float(n)", False),
}


@pytest.mark.parametrize("form", sorted(SYNC_FORMS))
def test_host_sync_forms(tmp_path, form):
    body, flagged = SYNC_FORMS[form]
    root = _write(tmp_path / "pkg", {"core/__init__.py": "",
                                     "core/mandator.py": f'''
import numpy as np
import torch


def tick(st: dict, t: int):
    return step(st, t)


def step(st: dict, t: int):
    {body}


def not_reached(st: dict):
    return st['x'].item()
'''})
    got = [(f.rule, f.line) for f in run_lint(root).active]
    if flagged:
        assert len(got) == 1 and got[0][0] == "R1", got
    else:
        assert got == [], got


def test_port_lints_clean():
    """src/repro_torch: no active finding, every suppression justified,
    and the tick is free of host syncs (no R1 finding at all)."""
    report = run_lint(SRC_PORT)
    assert report.active == [], "\n".join(format_table(report.active))
    assert all(f.pragma == "allowed" for f in report.findings)
    assert not [f for f in report.findings if f.rule == "R1"]


def test_cli_exit_codes_and_json_artifact(tmp_path, corpus, capsys):
    art = tmp_path / "findings.json"
    assert cli_main(["--root", str(corpus), "--quiet",
                     "--json", str(art)]) == 1
    findings = findings_from_json(json.loads(art.read_text()))
    assert sum(f.active for f in findings) == len(_expected(corpus))
    base = tmp_path / "base.json"
    assert cli_main(["--root", str(corpus), "--quiet",
                     "--update-baseline", str(base)]) == 0
    assert cli_main(["--root", str(corpus), "--quiet",
                     "--baseline", str(base)]) == 0
    # the port itself is the CLI's default root and lints clean
    assert cli_main(["--quiet"]) == 0
    capsys.readouterr()
