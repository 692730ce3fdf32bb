"""The port's benchmark history ledger (``repro_torch.obs.history``) and
the graph audit's ``append_history`` / ``--graph-history`` against the
reference's ``repro.obs.history`` and ``hlo_lint.append_history``: the
reference's own cases (tests/test_monitor.py) through both packages give
equal entries, raises, comparisons and formatted lines, and a ledger
either package writes loads in the other, byte for byte."""
import json

import pytest

from repro.analysis import hlo_lint
from repro.obs import history as jhistory
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import graph_lint
from repro_torch.obs import history

BOTH = (jhistory, history)


def _suites(wall=1.0, ok=True, viol=None, error=None):
    s = {"wall_s": wall, "compile_s": 0.5, "run_s": 0.5,
         "xla_compile_s": 0.4, "cache_hits": 1, "cache_misses": 0,
         "cache_saved_s": 0.1, "traces": 2,
         "monitor": {"ok": ok, "violations": viol or {}, "level": "full",
                     "points": 4}}
    if error:
        s["error"] = error
    return {"fig6": s}


def test_schema_equal():
    assert history.SCHEMA_VERSION == jhistory.SCHEMA_VERSION == 1
    assert history.SUITE_STATS == jhistory.SUITE_STATS


@pytest.mark.parametrize("mod", BOTH, ids=("reference", "port"))
def test_round_trip_and_validation(tmp_path, mod):
    """tests/test_monitor.py's round trip, through either package; the
    entries equal the other package's."""
    p = tmp_path / "hist.jsonl"
    e1 = mod.make_entry(_suites(wall=2.0), quick=True, git_sha="abc",
                        timestamp=100.0)
    assert e1 == jhistory.make_entry(_suites(wall=2.0), quick=True,
                                     git_sha="abc", timestamp=100.0)
    mod.append(p, e1)
    with p.open("a") as f:                     # ledger survives junk lines
        f.write("not json\n")
    e2 = mod.make_entry(_suites(wall=2.1), quick=True, git_sha="def",
                        timestamp=200.0)
    mod.append(p, e2)
    for reader in BOTH:
        entries = reader.load(p)
        assert entries == [e1, e2]
        assert reader.latest(p)["git_sha"] == "def"
    with pytest.raises(ValueError, match="ok=True with violations"):
        mod.validate_entry(mod.make_entry(_suites(ok=True,
                                                  viol={"stall": 3}),
                                          quick=False))
    with pytest.raises(ValueError, match="wall_s"):
        mod.validate_entry({"schema": 1, "git_sha": "x", "timestamp": 0.0,
                            "quick": False, "suites": {"fig6": {}}})
    assert mod.load(tmp_path / "absent.jsonl") == []
    assert mod.latest(tmp_path / "absent.jsonl") is None


BAD = ([], {"schema": 2, "git_sha": "x", "timestamp": 0.0, "quick": True,
            "suites": {"a": {"wall_s": 1.0}}},
       {"schema": 1, "git_sha": "x", "timestamp": 0.0, "quick": True,
        "suites": {}},
       {"schema": 1, "git_sha": "x", "timestamp": 0.0, "quick": True},
       {"schema": 1, "git_sha": "x", "timestamp": 0.0, "quick": True,
        "suites": {"a": {"wall_s": -1.0}}},
       {"schema": 1, "git_sha": "x", "timestamp": 0.0, "quick": True,
        "suites": {"a": {"wall_s": 1.0, "monitor": {"ok": 1,
                                                    "violations": {}}}}},
       {"schema": 1, "git_sha": "x", "timestamp": 0.0, "quick": True,
        "suites": {"a": {"wall_s": 1.0, "analysis": {"R1": 1.5}}}})


@pytest.mark.parametrize("i", range(len(BAD)))
def test_validation_raises_alike(i):
    msgs = []
    for mod in BOTH:
        with pytest.raises(ValueError) as e:
            mod.validate_entry(BAD[i])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_compare_and_format_equal():
    """tests/test_monitor.py's gate cases: the same statuses, ratios and
    lines from both packages."""
    base = history.make_entry(_suites(wall=10.0), quick=False)
    cases = [(base, _suites(wall=10.0), "ok"),
             (base, _suites(wall=12.0), "ok"),
             (base, _suites(wall=13.0), "warn"),
             (base, _suites(wall=1.0, ok=False, viol={"agreement": 2}),
              "fail"),
             (base, _suites(wall=1.0, error="ValueError"), "warn"),
             (None, _suites(wall=1.0, error="ValueError"), "warn")]
    for b, suites, status in cases:
        cur = history.make_entry(suites, quick=False)
        got, ref = history.compare(b, cur), jhistory.compare(b, cur)
        assert got == ref and got["fig6"]["status"] == status
        assert history.format_compare(got) == jhistory.format_compare(ref)
    row = history.compare(base, history.make_entry(_suites(wall=13.0),
                                                   quick=False))["fig6"]
    assert row["ratio"] == 1.3


def test_ledgers_cross_load_byte_for_byte(tmp_path):
    entries = [history.make_entry(_suites(wall=w, ok=ok, viol=v), quick=q,
                                  git_sha=s, timestamp=ts)
               for w, ok, v, q, s, ts in ((2.0, True, None, True, "a", 1.0),
                                          (3.5, False, {"stall": 2}, False,
                                           "b", 2.5))]
    paths = {}
    for mod in BOTH:
        paths[mod] = tmp_path / f"{mod.__name__}.jsonl"
        for e in entries:
            mod.append(paths[mod], e)
    assert paths[history].read_bytes() == paths[jhistory].read_bytes()
    assert jhistory.load(paths[history]) == history.load(paths[jhistory]) \
        == entries


VERDICT = {"ok": True, "violations": {}, "level": "graph", "points": 6,
           "protocols": {}, "signatures": {}, "wall_s": 1.25,
           "sim_seconds": 0.2, "device": "cpu"}


def test_append_history_lands_a_graph_audit_suite(tmp_path):
    """One valid entry under the suite name graph-audit (the reference's
    is hlo-audit, so compare never sets one against the other); apart
    from its name and timestamp the entry equals the reference's."""
    ours, ref = tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"
    graph_lint.append_history(ours, VERDICT,
                              analysis_counts={"active": 0, "R1": 0})
    hlo_lint.append_history(ref, VERDICT,
                            analysis_counts={"active": 0, "R1": 0})
    got, = jhistory.load(ours)
    want, = jhistory.load(ref)
    assert list(got["suites"]) == ["graph-audit"]
    assert got["suites"]["graph-audit"] == want["suites"]["hlo-audit"]
    assert {k: v for k, v in got.items() if k not in ("suites",
                                                      "timestamp")} == \
        {k: v for k, v in want.items() if k not in ("suites", "timestamp")}
    bad = dict(VERDICT, ok=True, violations={"f64_ops": 1})
    with pytest.raises(ValueError, match="ok=True with violations"):
        graph_lint.append_history(ours, bad)
    both = history.load(ours) + history.load(ref)
    cmp = history.compare(both[1], both[0])
    assert cmp["graph-audit"].get("base_wall_s") is None


def test_cli_graph_history_appends_one_entry(tmp_path, capsys):
    path = tmp_path / "BENCH_history.jsonl"
    rc = cli.main(["--graph", "--sim-seconds", "0.2", "--quiet",
                   "--graph-history", str(path)])
    entry, = history.load(path)
    assert entry == json.loads(path.read_text())
    suite = entry["suites"]["graph-audit"]
    assert suite["monitor"]["level"] == "graph"
    assert suite["monitor"]["ok"] and suite["wall_s"] > 0
    assert suite["analysis"]["active"] == rc == 0
