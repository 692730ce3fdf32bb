"""Fault scenarios in the benchmark's inputs and its plain reference.

``plainscen``'s tables equal the port's lowering of every library scenario;
a whole run on the CPU of a mix of every scenario comes out correct under
both protocols, with the Sporades asynchronous path compared; a fault
planted in the port's network tables alone comes out not correct; a mix
the reference cannot check is refused with its reason; the Fig-6 grids'
draws and reference rows are pinned to what they were before scenarios
were simulated."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import pb_check
import pb_inputs
import pb_registry
import plainscen
import run
from repro_torch import scenarios as port_sc
from repro_torch.configs.smr import SMRConfig as PortConfig
from repro_torch.core import netsim
from repro_torch.scenarios import library as port_scl

BIG_SEED = 2 ** 31 + 4242
# every scenario at two rates, one seed; 1 000 ticks, so that the paper's
# attack takes Sporades through a whole asynchronous view (at 400 ticks the
# view has not yet ended)
FAULTS = {"rates": [50000, 200000], "seeds_per_grid": 1,
          "scenarios": list(plainscen.NAMES), "workloads": ["poisson-open"],
          "smr": {"sim_seconds": 1.0}}


def _cell(name, traffic=None):
    cell = pb_registry.cell(pb_registry.load_benchmark(), name)
    return dataclasses.replace(cell, traffic=traffic or FAULTS)


def _digest(items):
    h = hashlib.sha256()
    for row in items:
        for k in sorted(row):
            a = np.asarray(row[k])
            h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("sim_seconds", [0.4, 2.0])
@pytest.mark.parametrize("n", [3, 5, 9])
def test_tables_equal_the_ports(n, sim_seconds):
    assert plainscen.NAMES == port_scl.NAMES
    cfg = PortConfig(n_replicas=n, sim_seconds=sim_seconds)
    settings = {"n_replicas": n, "tick_ms": cfg.tick_ms,
                "sim_seconds": sim_seconds}
    for name in (None,) + plainscen.NAMES:
        want = port_sc.lower(cfg, port_sc.as_scenario(
            None if name is None else port_scl.get(name, sim_seconds, n)))
        got = plainscen.lower(settings, name)
        assert set(got) == set(want), name
        for k, v in want.items():
            a, b = got[k], np.asarray(v)
            assert (a.dtype, a.shape) == (b.dtype, b.shape), (name, k)
            assert a.tobytes() == b.tobytes(), (name, k)


def _run(name, monkeypatch):
    """One CPU run of the faults mix; returns the result and the checked
    (port row, reference row, scenario) triples."""
    torch.set_num_threads(2)
    seen = []
    compare = pb_check.compare

    def keep(port_rows, grids, gi, lanes, ref_rows):
        for lane, ref in zip(lanes, ref_rows):
            fi = grids[gi].points[lane][2]
            seen.append((port_rows[gi][lane], ref, grids[gi].scenarios[fi]))
        return compare(port_rows, grids, gi, lanes, ref_rows)
    monkeypatch.setattr(pb_check, "compare", keep)
    out = run.run_cell(_cell(name), BIG_SEED + 7, 0.1, False, device="cpu")
    return out, seen


@pytest.mark.parametrize("name", ["sporades.fig6", "paxos.fig6"])
def test_faults_mix_is_correct(name, monkeypatch):
    out, seen = _run(name, monkeypatch)
    c = out["checks"]
    assert out["correct"], out["checks"]
    assert c["exact_mismatches"]["value"] == 0 and \
        c["max_ulps"]["value"] == 0
    # a lane of every scenario at the top rate, and of the other rate
    assert {s for _, _, s in seen} == set(plainscen.NAMES)
    assert c["lanes_checked"]["value"] == len(plainscen.NAMES) + 1
    if name == "sporades.fig6":
        ddos = [(p, r) for p, r, s in seen if s == "paper-ddos"]
        for row in ddos[0]:
            assert row["async_frac"] > 0 and row["views"] > 0


@pytest.mark.parametrize("plant", ["link_drop", "alive"])
def test_fault_under_scenarios_fails(plant, monkeypatch):
    """The port's network tables broken, which no fault-free lane reads:
    no link cut, or every replica up."""
    real = getattr(netsim, plant)

    def broken(env, t):
        x = real(env, t)
        return torch.zeros_like(x) if plant == "link_drop" \
            else torch.ones_like(x)
    monkeypatch.setattr(netsim, plant, broken)
    out, seen = _run("sporades.fig6", monkeypatch)
    assert not out["correct"]
    assert out["checks"]["exact_mismatches"]["value"] > 0
    baseline = [pb_check.compare_rows(p, r) for p, r, s in seen
                if s == "baseline"]
    assert baseline and all(not x["paths"] for x in baseline)


@pytest.mark.parametrize("change, why", [
    ({"smr": {"sim_seconds": 0.1, "trace_level": "full"}}, "flight recorder"),
    ({"smr": {"sim_seconds": 0.1, "monitor_level": "on"}}, "health monitor"),
    ({"workloads": ["closed-loop"]}, "no closed loop"),
    ({"scenarios": [None, "no-such-fault"]}, "no-such-fault"),
], ids=["trace", "monitor", "closed-loop", "unknown-scenario"])
def test_mix_the_reference_cannot_check_is_refused(change, why):
    cell = _cell("sporades.fig6", dict(FAULTS, **change))
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    with pytest.raises(ValueError, match="cannot check") as err:
        pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 1)
    assert why in str(err.value)


def test_draws_do_not_depend_on_the_scenario():
    """Lane b of grid k draws from ``SeedSequence([seed, k, b])`` at its
    rate, whatever its scenario."""
    cell = _cell("sporades.fig6")
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    g = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 3)
    assert g.lanes == 2 * len(plainscen.NAMES)
    T, n = g.draws.shape[1:]
    for b, (rate, _, _, _) in enumerate(g.points):
        rng = np.random.default_rng(np.random.SeedSequence([BIG_SEED, 3, b]))
        lam = np.full((T, n), pb_inputs.rate_per_tick(settings, rate),
                      np.float32)
        assert np.array_equal(g.draws[b],
                              rng.poisson(lam).astype(np.float32))


# sha256 of the Fig-6 grid 1's draw table at ``BIG_SEED``, and of the
# reference's rows of three lanes of grid 3 at 0.5 s, as the harness made
# them before it simulated scenarios
FIG6_DRAWS = ("2e84bf776fa37e1ca908b38a05b30f83"
              "69312ab500d3e3c34908ff9b3205dd28")
FIG6_ROWS = {
    "sporades.fig6": ("8f639a5e27bbbf026e31ec29cc88bffd"
                      "89dd85c9da3f4925d940196e4fdb40cc"),
    "paxos.fig6": ("1f9391806528123ab79d50b49c745dd3"
                   "a0d9528b9dda8088173c48b0ce157607")}


@pytest.mark.parametrize("name", sorted(FIG6_ROWS))
def test_fig6_inputs_and_rows_are_pinned(name):
    cell = pb_registry.cell(pb_registry.load_benchmark(), name)
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    g = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 1)
    h = hashlib.sha256(f"{g.draws.dtype.str}|{g.draws.shape}|".encode())
    h.update(np.ascontiguousarray(g.draws).tobytes())
    assert h.hexdigest() == FIG6_DRAWS
    tr = dict(cell.traffic, smr=dict(cell.traffic.get("smr", {}),
                                     sim_seconds=0.5))
    g = pb_inputs.make_grid(pb_inputs.smr_settings(cell.config, tr), tr,
                            BIG_SEED, 3)
    ref = pb_check.reference_rows(cell.config["protocol"], cell.config, tr,
                                  g, [g.lanes - 1, 0, 17])
    assert _digest(ref) == FIG6_ROWS[name]
