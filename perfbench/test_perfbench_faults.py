"""A whole run with the port broken underneath comes out not correct.

These drive ``run.run_cell`` on the CPU (the one step they skip is the
command's look for a CUDA device) on a tiny grid of a Fig-6 cell, with a
fault planted in the port: a tick that returns its state unchanged; half
of a grid's lanes left out, their rows taken from the other half; one
answer altered where it is produced. The exchange between chips is not a
fault these cells can have: each runs on one chip. An intact port comes
out correct. The last test runs every cell on the card, skipped without
one."""
import dataclasses

import pytest
import torch

import pb_registry
import run
from repro_torch.core import experiment, harness


def tiny_cell(name="sporades.fig6"):
    cell = pb_registry.cell(pb_registry.load_benchmark(), name)
    tr = dict(cell.traffic, rates=cell.traffic["rates"][-2:],
              seeds_per_grid=1,
              smr=dict(cell.traffic.get("smr", {}), sim_seconds=0.4))
    return dataclasses.replace(cell, traffic=tr)


def run_once(cell=None):
    torch.set_num_threads(2)
    return run.run_cell(cell or tiny_cell(), 2 ** 31 + 99, 0.2, False,
                        device="cpu")


def test_intact_port_is_correct():
    out = run_once()
    assert out["correct"], out["checks"]
    assert out["checks"]["lanes_checked"]["value"] == 2


def test_unchanged_state_fails(monkeypatch):
    def frozen(carry, t, arr, env, cfg, protocol, grace):
        return dict(carry), {}
    monkeypatch.setattr(harness, "_tick", frozen)
    out = run_once()
    assert not out["correct"]
    c = out["checks"]
    assert c["exact_mismatches"]["value"] > 0 or \
        c["max_ulps"]["value"] > c["max_ulps"]["limit"]


def test_half_the_lanes_left_out_fails(monkeypatch):
    rows = experiment._rows

    def half(protocol, pts, wl_names, out):
        got = rows(protocol, pts, wl_names, out)
        h = len(got) // 2
        for i in range(h, len(got)):
            keep = {k: got[i][k] for k in ("rate", "seed", "workload")}
            got[i] = dict(got[i - h], **keep)
        return got
    monkeypatch.setattr(experiment, "_rows", half)
    out = run_once()
    assert not out["correct"]
    assert out["failed"] >= 1


def test_altered_answer_fails(monkeypatch):
    metrics = harness._batch_metrics

    def altered(*a, **k):
        out = metrics(*a, **k)
        tput = out["throughput"].clone()
        tput[-1] = tput[-1] * (1 + 1e-4) + 1e-3
        return dict(out, throughput=tput)
    monkeypatch.setattr(harness, "_batch_metrics", altered)
    out = run_once()
    assert not out["correct"]
    assert out["checks"]["max_ulps"]["value"] > \
        out["checks"]["max_ulps"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name", [w["name"] for w in pb_registry.load_benchmark()["workloads"]])
def test_cells_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's "
                    "captured ticks and its channel-ring kernel")
    cell = pb_registry.cell(pb_registry.load_benchmark(), name)
    out = run.run_cell(cell, 2 ** 31 + 5, 1.0, True, device="cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
