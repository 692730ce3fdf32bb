"""The port's default arrival source (one torch.Generator per lane, drawn
with torch.Poisson) against the reference's jax.random draws: the bits
differ, so the two are held statistically. Over seeds (0, 1, 2) at
100k tx/s, 1.5 s, baseline: the mean throughput lies within 2% of the
reference's and the mean median latency within 10%. (Across these seeds
the reference's own throughput spreads by about 0.6% and its median by
about 0.1%.)"""
import numpy as np

from repro.configs.smr import SMRConfig as JCfg
from repro.core.experiment import SweepSpec as JSpec
from repro.core.experiment import run_sweep as jax_run_sweep
from repro_torch.configs.smr import SMRConfig
from repro_torch.core.experiment import SweepSpec, run_sweep

SIM_S = 1.5
SEEDS = (0, 1, 2)
RATE = 100_000


def test_default_poisson_source_matches_reference_statistically():
    ref = jax_run_sweep("mandator-sporades", JCfg(sim_seconds=SIM_S),
                        JSpec(rates=(RATE,), seeds=SEEDS))
    port = run_sweep("mandator-sporades", SMRConfig(sim_seconds=SIM_S),
                     SweepSpec(rates=(RATE,), seeds=SEEDS), device="cpu")
    tput_r = np.mean([r["throughput"] for r in ref])
    tput_p = np.mean([r["throughput"] for r in port])
    med_r = np.mean([r["median_ms"] for r in ref])
    med_p = np.mean([r["median_ms"] for r in port])
    assert abs(tput_p - tput_r) <= 0.02 * tput_r, (tput_p, tput_r)
    assert abs(med_p - med_r) <= 0.10 * med_r, (med_p, med_r)
    # the draws really differ from the reference's: this is not a replay
    assert [r["committed"] for r in port] != [r["committed"] for r in ref]
    # and a lane's draws depend on its seed only
    assert len({r["committed"] for r in port}) == len(SEEDS)
