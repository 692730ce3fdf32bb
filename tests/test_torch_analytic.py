"""The analytic baselines (repro_torch.core.epaxos / rabia, host numpy)
against the JAX package's: the rows of Fig 6's rate grids, through both
sweep engines on one scenario, are equal exactly, keys and values (both
are deterministic numpy). They touch no device, so they run with
``device=None`` where torch sees no card. They take every workload and
trace/monitor level (tests/test_torch_workloads.py holds their rows under
each library workload); what they cannot take — arrival tables — raises."""
import numpy as np
import pytest
import torch

from repro.configs.smr import SMRConfig as JCfg
from repro.core.experiment import SweepSpec as JSpec
from repro.core.experiment import run_sweep as jax_run_sweep
from repro.scenarios import library as jlib
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import experiment
from repro_torch.core.experiment import SweepSpec, dispatch_sweep, run_sweep
from repro_torch.scenarios import library
from repro_torch.workloads import PoissonOpen, Workload

# benchmarks/figures.py fig6_throughput_latency
FIG6_RATES = {"epaxos": (2_000, 5_000, 10_000, 20_000),
              "rabia": (200, 500, 1_000, 2_000)}
SCENARIO = "paper-ddos"


@pytest.mark.parametrize("protocol", sorted(FIG6_RATES))
def test_rows_equal_reference(protocol):
    rates = FIG6_RATES[protocol]
    ref = jax_run_sweep(protocol, JCfg(),
                        JSpec(rates=rates, seeds=(0, 1),
                              scenarios=(jlib.get(SCENARIO, 10.0),)))
    got = dispatch_sweep(protocol, SMRConfig(),
                         SweepSpec(rates=rates, seeds=(0, 1),
                                   scenarios=(library.get(SCENARIO, 10.0),))
                         ).collect()
    assert len(got) == len(ref) == 2 * len(rates)
    assert any(r["committed"] > 0 for r in got)
    for r, g in zip(ref, got):
        assert r.keys() == g.keys()
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == g[k].dtype, k
                np.testing.assert_array_equal(v, g[k], err_msg=k)
            else:
                assert type(v) is type(g[k]), k
                assert v == g[k] or (np.isnan(v) and np.isnan(g[k])), (k, v,
                                                                        g[k])


@pytest.mark.parametrize("protocol", experiment.ANALYTIC_PROTOCOLS)
def test_analytic_models_touch_no_device(protocol):
    """device=None means CUDA for the scan protocols; the host models run
    whatever torch sees."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to show")
    rows = run_sweep(protocol, SMRConfig(),
                     SweepSpec(rates=(FIG6_RATES[protocol][-1],)))
    assert rows[0]["protocol"] == protocol and rows[0]["throughput"] > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep("multipaxos", SMRConfig(sim_seconds=0.1),
                  SweepSpec(rates=(1_000,)))


@pytest.mark.parametrize("protocol", experiment.ANALYTIC_PROTOCOLS)
def test_analytic_unported_paths_raise(protocol):
    """What raised before the flight recorder, the monitor and the
    windowed workloads were ported now runs: tracing adds the phase
    breakdown, monitoring a verdict, a windowed workload changes the
    answer. Arrival tables still raise: the models draw none."""
    spec = SweepSpec(rates=(1_000,))
    base, = run_sweep(protocol, SMRConfig(), spec)
    traced, = run_sweep(protocol, SMRConfig(trace_level="full"), spec)
    assert len(traced["phase_med_ms"]) == 4
    monitored, = run_sweep(protocol, SMRConfig(monitor_level="full"), spec)
    assert monitored["monitor"]["ok"]
    for r in (traced, monitored):
        assert r["throughput"] == base["throughput"]
    half, = run_sweep(protocol, SMRConfig(), SweepSpec(
        rates=(1_000,), workloads=(Workload("half", (PoissonOpen(0.5),)),)))
    assert half["workload"] == "half"
    assert half["committed"] != base["committed"]
    with pytest.raises(ValueError, match="draws"):
        run_sweep(protocol, SMRConfig(), spec,
                  draws=np.zeros((1, 10_000, 5), np.float32))
    with pytest.raises(ValueError, match="draws"):
        run_sweep(protocol, SMRConfig(), spec,
                  epochs=np.zeros((1, 5, 8), np.float64))
