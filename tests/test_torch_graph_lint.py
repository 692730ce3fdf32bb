"""The captured tick's audit (repro_torch.analysis.graph_lint, G1-G4) and
what it reads (repro_torch.distributed.graph_analysis), on the CPU.

On the reference's audit grid (its three scenarios x two rates, the
``onoff-burst`` workload) every scan protocol is clean: its float64 ops
come from justified lines only (G1), no op of its tick reads back or moves
data between devices (G2), its carry keeps its shapes and dtypes and the
CPU loop is counted eager (G3's host side), and every point lowers to one
``ProgramSignature`` whose sweeps share one program key (G4). Each rule
also fires on a tick broken on purpose, and the lint's R1 sees the tick
index ``t`` as a tensor."""
import json

import pytest
import torch

from repro_torch.analysis import findings, graph_lint, run_lint
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core import experiment, harness, netsim
from repro_torch.distributed import graph_analysis as ga

QUICK = ("mandator",)


@pytest.fixture(scope="module")
def verdict():
    return graph_lint.audit(sim_seconds=2.0)


def test_audit_grid_is_clean(verdict):
    assert verdict["ok"], graph_lint.format_verdict(verdict)
    assert verdict["level"] == "graph" and verdict["points"] == 6
    for p in harness.PROTOCOLS:
        d = verdict["protocols"][p]
        assert d["f64_unjustified"] == 0 and d["host_transfers"] == 0
        assert d["loop_problems"] == 0
        # the form_batches remainder is float64 on purpose (justified)
        assert d["f64_ops"] > 0
        assert set(d["ops_per_tick"]) == {"trivial", "windowed",
                                          "telemetry-full"}
        assert d["dtype_ops"]["trivial"]["f32"] > 0
        assert sum(v.get("f64", 0) for v in d["dtype_ops"].values()) \
            == d["f64_ops"]
    for p in experiment.ANALYTIC_PROTOCOLS:
        assert verdict["protocols"][p]["program"] is None
    for tag in ("trivial", "windowed"):
        g = verdict["signatures"][tag]
        assert len(g["signatures"]) == 1
        assert all(g["second_sweep_reuses"].values())
    text = graph_lint.format_verdict(verdict)
    assert text.startswith("graph-audit OK") and "grid[windowed]" in text


def _broken(monkeypatch, fn):
    """Wrap netsim.egress_delay, which every scan protocol's tick calls."""
    orig = netsim.egress_delay

    def egress_delay(busy, t, bytes_out):
        fn(busy)
        return orig(busy, t, bytes_out)
    monkeypatch.setattr(netsim, "egress_delay", egress_delay)


def test_g2_fires_on_a_read_back(monkeypatch):
    _broken(monkeypatch, lambda busy: float(busy.sum()))
    report = findings.Report()
    v = graph_lint.audit(protocols=QUICK, sim_seconds=0.5, report=report)
    assert v["violations"]["host_transfer_in_tick"] == 3   # one a variant
    assert [f.rule for f in report.findings] == ["G2"]
    assert "aten::_local_scalar_dense" in report.findings[0].message


def test_g1_fires_on_an_unjustified_float64(monkeypatch):
    _broken(monkeypatch, lambda busy: busy.double() + 1.0)
    report = findings.Report()
    v = graph_lint.audit(protocols=QUICK, sim_seconds=0.5, report=report)
    assert v["violations"]["f64_ops"] == 6      # two ops, three variants
    assert [f.rule for f in report.findings] == ["G1"]


def test_g3_fires_when_a_leaf_changes_dtype(monkeypatch):
    orig = harness._tick

    def tick(carry, t, *a):
        late = int(t) >= 2          # the test's own read of t
        carry, out = orig(carry, t, *a)
        if not late:
            return carry, out
        m = dict(carry["m"])
        m["own_round"] = m["own_round"].long()
        return dict(carry, m=m), out
    monkeypatch.setattr(harness, "_tick", tick)
    report = findings.Report()
    v = graph_lint.audit(protocols=QUICK, sim_seconds=0.5, report=report)
    # the test's own read of t is a host transfer G2 sees, too
    assert v["violations"] == {"graph_loop": 1, "host_transfer_in_tick": 3}
    assert sorted(f.rule for f in report.findings) == ["G2", "G3"]


def test_g4_fires_without_canonical_windows(monkeypatch):
    monkeypatch.setattr(experiment, "CANONICAL_MIN_WINDOWS", 1)
    report = findings.Report()
    v = graph_lint.audit(protocols=QUICK, sim_seconds=0.5, report=report)
    assert v["violations"]["signature_drift"] >= 1
    assert {f.rule for f in report.findings} == {"G4"}


def test_cli_graph(capsys, tmp_path):
    out = tmp_path / "f.json"
    assert cli_main(["--graph", "--sim-seconds", "0.5",
                     "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "graph-audit OK" in text and "0 active finding(s)" in text
    assert all(f["rule"] not in ("G1", "G2", "G3", "G4")
               for f in json.loads(out.read_text()))


def test_rule_keys():
    for rule, key in (("G1", "graph-f64"), ("G2", "graph-host-sync"),
                      ("G3", "graph-loop"), ("G4", "graph-signature")):
        assert findings.RULE_KEYS[rule] == key
        assert findings.KEY_RULES[key] == rule


def test_recorder_counts_dtypes_and_transfers():
    x = torch.arange(6, dtype=torch.float32)

    def fn():
        y = (x * 2).double()
        i = torch.nonzero(x > 2)
        return float(y.sum()), i
    _, ops = ga.record_ops(fn)
    counts = ga.dtype_op_counts(ops)
    assert counts["f64"] >= 2 and counts["f32"] >= 1
    names = [op.name for op in ga.host_transfer_ops(ops)]
    assert "aten::nonzero" in names and \
        "aten::_local_scalar_dense" in names
    assert all(op.site is None for op in ops)     # not the port's source


def test_dot_parsing():
    text = '''digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="solid" shape="record" label="{KERNEL
| {ID | 0 | 0x7f}
| {func | _Z13commit_kernelILi8EEvPfPKf6ParamsPKi}}"];
"graph_1_node_1"[style="solid" shape="record" label="{KERNEL | _ZN2at6native18elementwise_kernelILi128ELi4EEEviT1_}"];
"graph_1_node_2"[style="solid" shape="record" label="{MEMSET | x}"];
"graph_1_node_0" -> "graph_1_node_1" [style="solid"];
}
}'''
    d = ga.parse_graph_dot(text)
    assert d["nodes"] == 3 and d["types"] == {"KERNEL": 2, "MEMSET": 1}
    assert d["kernels"] == {
        "_Z13commit_kernelILi8EEvPfPKf6ParamsPKi": 1,
        "_ZN2at6native18elementwise_kernelILi128ELi4EEEviT1_": 1}


def test_r1_sees_the_tick_index_as_a_tensor(tmp_path):
    root = tmp_path / "corpus"
    root.mkdir()
    (root / "ticks.py").write_text('''
def helper(x, t):
    return float(t) + x


def counted(x, t: int):
    return int(t) + x


# lint: traced-root
def root(x, t):
    return helper(x, t) + counted(x, 3)
''')
    report = run_lint(root, rules=("R1",))
    got = sorted((f.rule, f.line) for f in report.active)
    assert got == [("R1", 3)]
