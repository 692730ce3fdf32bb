"""The port's example scripts (``examples/torch_*.py``) on the CPU, at cut
sizes, with ``device="cpu"``:

- the wan demo's scenario showcase (region-outage, 0.5 s) against the
  reference script's ``scenario_showcase`` on the same arguments, its
  printed lines captured with ``capsys``: the port runs from the
  reference's own arrival draws (computed with JAX and replayed through
  ``run_sweep(..., draws=)``, as tests/test_torch_slice.py does), and the
  lines match one for one, each number equal or one unit of its last
  printed digit apart (the slice test's tolerances, throughput within
  1e-6 relative and the timeline within 1e-6 of its largest bucket, can
  move a printed rounding by at most that);
- the paper tour, whose protocols go through one ``run_sweeps``, prints
  the rows ``run_sweep`` gives each request alone, bitwise;
- the workload showcase and the flight recorder through ``main(argv)``,
  the written trace valid under ``obs.export.validate``;
- the model examples (quickstart, serve_batch, train_smr_cluster) with
  the reference scripts' own assertions: a falling loss, finite losses,
  every step committed, tokens in range;
- each ``main()`` passes ``--device`` on, and without it asks for CUDA
  (tests/test_torch_isolation.py checks that it raises here).
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
from torch_sim_parity import jax_draw_table, single_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core.experiment import run_sweep
from repro_torch.obs import export

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SIM_S = 0.5
CPU = "cpu"


def _load(name: str):
    """An example script as a module, imported by its path."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def replayed_run_sweeps(requests, device=None):
    """``run_sweeps`` with every lane's arrivals the reference's own."""
    out = []
    for protocol, cfg, spec in requests:
        ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
        # the reference's rate_b: float64 on the host, then float32
        draws = np.stack([jax_draw_table(
            seed, ticks, np.float32(rate * cfg.tick_ms / 1000.0
                                    / cfg.n_replicas), cfg.n_replicas)
            for rate, seed, _, _ in spec.points()])
        out.append(run_sweep(protocol, cfg, spec, device=device,
                             draws=draws))
    return out


_NUM = re.compile(r"nan|-?\d[\d,]*(?:\.\d+)?")


def _same_line(got: str, want: str) -> None:
    """The same text; each number equal (nan too) or one unit of its last
    printed digit apart."""
    assert _NUM.sub("#", got) == _NUM.sub("#", want), (got, want)
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        if g == w:
            continue
        assert "nan" not in (g, w), (got, want)
        unit = 10.0 ** -len(w.split(".")[1]) if "." in w else 1.0
        gv, wv = (float(x.replace(",", "")) for x in (g, w))
        assert abs(gv - wv) <= unit * (1 + 1e-9), (got, want)


def test_scenario_showcase_matches_reference(capsys, monkeypatch):
    ref = _load("wan_consensus_demo")
    ref.scenario_showcase("region-outage", SIM_S, 100_000)
    want = capsys.readouterr().out.splitlines()
    demo = _load("torch_wan_consensus_demo")
    monkeypatch.setattr(demo, "run_sweeps", replayed_run_sweeps)
    rows = demo.main(["--scenario", "region-outage", "--sim-seconds",
                      str(SIM_S), "--device", CPU])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) > 10, (got, want)
    for g, w in zip(got, want):
        _same_line(g, w)
    assert set(rows) == {"mandator-sporades", "mandator-paxos",
                         "multipaxos"}
    assert all(r["committed"] > 0 for r in rows.values())


def test_paper_tour_prints_the_rows_of_run_sweep(capsys):
    demo = _load("torch_wan_consensus_demo")
    out = demo.paper_tour(sim_s=SIM_S, crash_s=0.25, device=CPU)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("== best-case WAN")
    assert "leader crash at t=0.25s" in lines[7]
    assert [ln.split()[0] for ln in lines[1:6]] == \
        [p for p, _ in demo.TOUR_RATES]
    cfg = demo.SMRConfig(sim_seconds=SIM_S)
    alone = {p: run_sweep(p, cfg, demo.SweepSpec(rates=(rate,)),
                          device=CPU)[0] for p, rate in demo.TOUR_RATES}
    crash = demo.SweepSpec(rates=(100_000,), scenarios=(demo.Scenario(
        "leader-crash", (demo.Crash(start_s=0.25, targets=(0,)),)),))
    for p in ("mandator-sporades", "mandator-paxos"):
        alone[("crash", p)] = run_sweep(p, cfg, crash, device=CPU)[0]
    got = {**out["tour"], **{("crash", p): r
                             for p, r in out["crash"].items()}}
    assert set(got) == set(alone)
    for key, row in got.items():
        assert set(row) == set(alone[key]), key
        for k, v in row.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(alone[key][k]),
                                          err_msg=f"{key} {k}")
    assert out["tour"]["mandator-sporades"]["throughput"] > 0


def test_workload_showcase_closed_loop_under_ddos(capsys):
    demo = _load("torch_wan_consensus_demo")
    rows = demo.main(["--workload", "closed-loop", "--scenario",
                      "paper-ddos", "--sim-seconds", str(SIM_S),
                      "--device", CPU])
    text = capsys.readouterr().out
    assert text.startswith("== workload 'closed-loop' under scenario "
                           "'paper-ddos'")
    assert "client-pool target" in text
    for proto in ("mandator-sporades", "mandator-paxos"):
        r = rows[proto]
        assert np.asarray(r["inflight_max"]).shape == (5,)
        assert np.asarray(r["origin_lat_ms_timeline"]).shape[0] == 5
    assert text.count("max in-flight") == 10
    assert text.count("lat/ms") == 10


def test_traced_run_writes_a_valid_trace(capsys, tmp_path):
    demo = _load("torch_wan_consensus_demo")
    path = tmp_path / "ddos.json"
    rows = demo.main(["--trace", str(path), "--scenario", "paper-ddos",
                      "--rate", "300000", "--sim-seconds", str(SIM_S),
                      "--device", CPU])
    text = capsys.readouterr().out
    assert text.count(" phase              median") == 2
    assert f"# wrote {path}" in text
    assert rows["trace"] == path
    trace = json.loads(path.read_text())
    export.validate(trace)
    assert trace["otherData"]["protocol"] == "mandator-sporades"
    assert trace["otherData"]["scenario"] == "paper-ddos"
    assert "phase_med_ms" in rows["mandator-paxos"]


def test_quickstart_trains_resumes_and_decodes(capsys):
    qs = _load("torch_quickstart")
    out = qs.quickstart(steps=20, resume_steps=24, batch=8, seq=32, gen=6,
                        device=CPU)
    text = capsys.readouterr().out
    first, again = out["first"]["losses"], out["resumed"]["losses"]
    assert len(first) == 20 and np.isfinite(first).all()
    assert first[-1] < first[0]
    assert "[restore] resumed at step 20" in text
    assert len(again) == 4                 # steps 20-23 after the restore
    assert out["first"]["commits"] == [20] and \
        out["resumed"]["commits"] == [4]
    toks = out["serve"]["tokens"]
    vocab = get_config("smollm-135m").reduced().vocab
    assert toks.shape == (2, 6) and ((toks >= 0) & (toks < vocab)).all()


def test_train_smr_cluster_commits_every_step(capsys):
    ex = _load("torch_train_smr_cluster")
    out = ex.train_smr_cluster(steps=8, crash_at=3, batch=6, seq=16,
                               device=CPU)
    text = capsys.readouterr().out
    assert "[fault] pod 2 crashed at step 3" in text
    losses = out["train"]["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    # the live controllers commit every step, the crashed one until it
    # crashed
    assert out["train"]["commits"] == [8, 8, 3]
    recs = out["records"]
    assert len(recs) == 5 and all(r is not None for r in recs)
    assert recs[0].mode == "async" and out["views"][-1] > 1
    assert out["quorum"] == ([0, 1, 2], True)


def test_serve_batch_serves_every_modality(capsys):
    ex = _load("torch_serve_batch")
    out = ex.serve_batch(batch=2, prompt_len=8, gen=6, device=CPU)
    text = capsys.readouterr().out
    assert list(out) == ["qwen3-14b", "musicgen-medium",
                         "llama-3.2-vision-11b"]
    for arch, res in out.items():
        vocab = get_config(arch).reduced().vocab
        toks = res["tokens"]
        assert toks.shape == (2, 6) and toks.dtype == np.int32
        assert ((toks >= 0) & (toks < vocab)).all(), arch
        assert f"[serve] {arch}: batch=2 prompt=8 gen=6" in text


FUNCS = {"torch_quickstart": "quickstart",
         "torch_serve_batch": "serve_batch",
         "torch_train_smr_cluster": "train_smr_cluster",
         "torch_wan_consensus_demo": "paper_tour"}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_main_passes_the_device_on(name, monkeypatch):
    """``main(argv)`` hands ``--device`` to the example's function, and
    None (CUDA) without it."""
    mod = _load(name)
    seen = []
    monkeypatch.setattr(mod, FUNCS[name],
                        lambda *a, device=None, **k: seen.append(device))
    mod.main(["--device", CPU])
    mod.main([])
    assert seen == [CPU, None]


def test_every_example_has_a_port():
    """Each reference example has its examples/torch_*.py counterpart."""
    ref = {p.stem for p in EXAMPLES.glob("*.py")
           if not p.stem.startswith("torch_")}
    assert {f"torch_{n}" for n in ref} == set(FUNCS)
