"""The port's batched sweep engine (repro_torch.core.experiment): a grid run
as one B-lane dispatch equals the same points run one by one, bit for bit
(the port's copy of tests/test_experiment.py's grid-vs-sequential
property), and every protocol takes tracing, monitoring and any workload
while a name that is no protocol or level raises."""
import numpy as np
import pytest

from repro_torch.configs.smr import SMRConfig
from repro_torch.core import experiment
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.workloads import PoissonOpen, Workload

CFG = SMRConfig(sim_seconds=0.8)
SCALARS = ("throughput", "median_ms", "p99_ms", "committed", "async_frac",
           "views")
ARRAYS = ("timeline", "origin_median_ms", "origin_p99_ms", "cvc_all",
          "commit_key")


def test_grid_matches_sequential_runs():
    """2 rates x 2 seeds through one 4-lane dispatch == four single-point
    runs, bitwise, with the port's default per-lane Poisson draws."""
    spec = SweepSpec(rates=(40_000, 120_000), seeds=(0, 1))
    experiment.reset_timing_stats()
    grid = run_sweep("mandator-sporades", CFG, spec, device="cpu")
    stats = experiment.timing_stats()["mandator-sporades"]
    assert stats["horizon"] == 256 and stats["run_s"] > 0
    assert len(grid) == spec.size == 4
    assert any(r["committed"] > 0 for r in grid)
    for r, (rate, seed, _, _) in zip(grid, spec.points()):
        assert (r["rate"], r["seed"]) == (rate, seed)
        single, = run_sweep("mandator-sporades", CFG,
                            SweepSpec(rates=(rate,), seeds=(seed,)),
                            device="cpu")
        for k in SCALARS:
            a, b = r[k], single[k]
            assert a == b or (np.isnan(a) and np.isnan(b)), (k, a, b)
        for k in ARRAYS:
            np.testing.assert_array_equal(r[k], single[k], err_msg=k)


@pytest.mark.parametrize("proto", ("mandator-sporades", "mandator-paxos",
                                   "multipaxos", "mandator"))
def test_unported_paths_raise(proto):
    """Every scan protocol runs (see tests/test_torch_paxos.py,
    tests/test_torch_mandator_alone.py), and what raised
    NotImplementedError before the flight recorder, the monitor and the
    windowed workloads were ported now runs and adds its outputs; a name
    that is no protocol, or no trace level, raises ValueError."""
    cfg = SMRConfig(sim_seconds=0.2)
    spec = SweepSpec(rates=(10_000,))
    traced, = run_sweep(proto, SMRConfig(sim_seconds=0.2,
                                         trace_level="full"), spec,
                        device="cpu")
    assert traced["phase_med_ms"].shape == (4,) and traced["obs"]
    monitored, = run_sweep(proto, SMRConfig(sim_seconds=0.2,
                                            monitor_level="full"), spec,
                           device="cpu")
    assert monitored["mon"]["viol"].shape == (6,)
    half, = run_sweep(proto, cfg,
                      SweepSpec(rates=(10_000,), workloads=(
                          Workload("half", (PoissonOpen(0.5),)),)),
                      device="cpu")
    assert half["workload"] == "half"
    with pytest.raises(ValueError, match="not-a-protocol"):
        run_sweep("not-a-protocol", CFG, spec, device="cpu")
    with pytest.raises(ValueError, match="trace_level"):
        run_sweep(proto, SMRConfig(trace_level="loud"), spec, device="cpu")
