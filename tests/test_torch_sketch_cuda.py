"""The sketch's bucket-sum kernel (csrc/sketch_buckets.cu) on the card:
against its plain version on the CPU bit for bit (both add each bucket's
entries in index order, in float32), on sorted runs with most entries of
zero weight, ties and empty buckets; and the sketch and a reduced sweep
built on the card against the same built on the CPU. Skips without a CUDA
device; run it on the card with

    PYTHONPATH=src python -m pytest -q --noconftest <this file>

(``--noconftest``: tests/conftest.py imports the JAX package.)
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().view(torch.int32)


@pytest.mark.parametrize("lanes,m,zero_frac", [(16, 50_000, 0.8),
                                               (3, 1, 0.0), (2, 777, 1.0),
                                               (5, 4096, 0.3)])
def test_kernel_matches_plain_bitwise(lanes, m, zero_frac):
    _need_card()
    from repro_torch.kernels.sketch_buckets import kernel
    from repro_torch.kernels.sketch_buckets.ref import bucket_sums_ref
    rng = np.random.default_rng(lanes * m)
    b = np.sort(rng.integers(0, 64, (lanes, m)), axis=1).astype(np.int32)
    b[:, m // 2:] = 63                   # one long run, as the dead records
    w = rng.integers(1, 2000, (lanes, m)).astype(np.float32)
    w[rng.random((lanes, m)) < zero_frac] = 0.0
    v = rng.gamma(2.0, 50.0, (lanes, m)).astype(np.float32)
    wv = np.where(w > 0, w * v, 0.0).astype(np.float32)
    args = [torch.from_numpy(x) for x in (b, w, wv)]
    before = kernel.launch_count
    got = kernel.bucket_sums_cuda(*(x.cuda() for x in args), 64)
    assert kernel.launch_count == before + 1
    want = bucket_sums_ref(*args, 64)
    for g, r in zip(got, want):
        assert torch.equal(_bits(g), _bits(r))


def test_sketch_and_reduced_sweep_card_vs_cpu():
    _need_card()
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.distributed import sketch
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.gamma(2.0, 50.0, (4, 3000)).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 5, (4, 3000)).astype(np.float32))
    card = sketch.build(v.cuda(), w.cuda())
    cpu = sketch.build(v, w)
    for k in ("v", "w"):
        assert torch.equal(_bits(card[k]), _bits(cpu[k]))
    cfg = SMRConfig(sim_seconds=0.3)
    spec = SweepSpec(rates=(50_000, 150_000))
    draws = rng.poisson(20.0, (2, 300, 5)).astype(np.float32)
    on_card = run_sweep("mandator-sporades", cfg, spec, draws=draws, mesh=1)
    on_cpu = run_sweep("mandator-sporades", cfg, spec, draws=draws,
                       mesh=[torch.device("cpu")])
    for a, b in zip(on_card, on_cpu):
        for k in ("throughput", "median_ms", "p99_ms", "committed"):
            assert np.float32(a[k]).tobytes() == np.float32(b[k]).tobytes()
        for k in ("v", "w"):
            assert np.array_equal(a["sketch"][k].view(np.uint32),
                                  b["sketch"][k].view(np.uint32))
