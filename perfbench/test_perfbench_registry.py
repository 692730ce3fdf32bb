"""The benchmark's files are found by name, and BENCHMARK.json keeps to the
benchmark's contract; a throwaway configuration, traffic mix and metric
run without any edit to the harness."""
import json
import re
import shutil

import pb_registry
import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_every_cell_resolves():
    bench = pb_registry.load_benchmark()
    for w in bench["workloads"]:
        cell = pb_registry.cell(bench, w["name"])
        assert cell.config["protocol"] in ("mandator-sporades",
                                           "mandator-paxos")
        assert cell.traffic["rates"] and cell.traffic["seeds_per_grid"] >= 1
        assert {m.name for m in cell.end_to_end} >= {"setup_s",
                                                     "lane_ticks_per_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(pb_registry.reader(m.name))


def test_contract_shape():
    bench = pb_registry.load_benchmark()
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for key, kind in (("configs", "config"), ("workloads", "cell"),
                      ("end_to_end", "e2e"), ("per_layer", "layer")):
        for e in bench[key]:
            extra = set(e) - KEYS[kind] - {"workloads"}
            assert set(e) >= KEYS[kind] and not extra, (e, extra)
            assert NAME.match(e["name"]), e["name"]
            assert (key, e["name"]) not in names
            names.add((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer", "source"):
                if k in e and isinstance(e[k], str):
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(bench)) < 64 * 1024


def _tree(tmp_path):
    """A checkout holding BENCHMARK.json and perfbench/ alone."""
    root = tmp_path / "checkout"
    shutil.copytree(pb_registry.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(pb_registry.ROOT / "BENCHMARK.json", root)
    return root


def test_throwaway_entries_need_no_edit(tmp_path):
    root = _tree(tmp_path)
    pb = root / "perfbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pb / "configs" / "mandator-paxos.wan5.json")
                     .read_text())
    cfg["name"] = "mandator-paxos.wan3"
    cfg["smr"]["n_replicas"] = 3
    (pb / "configs" / "mandator-paxos.wan3.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(
        {"rates": [1000], "seeds_per_grid": 1,
         "smr": {"sim_seconds": 0.1}}))
    (pb / "metrics" / "lanes_seen.py").write_text(
        "def read(obs):\n    return obs['grid_lanes']\n")
    bench["configs"].append({"name": "mandator-paxos.wan3",
                             "source": "https://arxiv.org/abs/2209.06152",
                             "file": "perfbench/configs/"
                                     "mandator-paxos.wan3.json",
                             "reduced": ["n_replicas"], "why": "test"})
    bench["workloads"].append({"name": "paxos.tiny",
                               "config": "mandator-paxos.wan3",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "lanes_seen", "unit": "lanes",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "sweep engine",
                               "moves": "lane_ticks_per_s",
                               "workloads": ["paxos.tiny"]})
    cell = pb_registry.cell(bench, "paxos.tiny", base=root)
    assert cell.config["smr"]["n_replicas"] == 3
    assert cell.traffic["rates"] == [1000]
    assert [m.name for m in cell.per_layer] == ["lanes_seen"]
    assert pb_registry.reader("lanes_seen", base=pb)({"grid_lanes": 7}) == 7
    # and the throwaway cell runs, traced, with its metric read
    out = run.run_cell(cell, 2 ** 31 + 3, 0.1, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"] == {"lanes_seen": {"value": 1, "unit": "lanes"}}
