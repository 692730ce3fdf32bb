"""The CUDA channel-ring kernel against its plain PyTorch version, bitwise,
on the card: random tick traffic (drops, in-slot collisions, 2*D ticks at
D=256, B=16) through the sporades, mandator and additive layouts. The
layouts and the traffic are chip_smoke.py's own (``layouts``,
``random_sends``), so the two checks cannot drift apart. Skips without a
CUDA device; run it on the card with

    PYTHONPATH=src python -m pytest -q --noconftest <this file>

(``--noconftest``: tests/conftest.py imports the JAX package.)
"""
import importlib.util
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", ["sporades", "mandator", "additive"])
def test_kernel_matches_plain_bitwise(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core import channel as ch
    from repro_torch.kernels.channel_ring import kernel

    smoke = _chip_smoke()
    B, D, N = smoke.B, smoke.D, 5
    spec, names = smoke.layouts()[layout]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    ring_k = ch.make_ring(spec, D, N, B, dev)
    ring_r = {"buf": ring_k["buf"].clone()}
    before = kernel.launch_count
    for t in range(2 * D):
        sends, drop = smoke.random_sends(spec, names, N, gen, ch)
        ring_k = ch.ring_commit(spec, ring_k, t, sends, drop=drop,
                                backend="cuda")
        ring_r = ch.ring_commit(spec, ring_r, t, sends, drop=drop,
                                backend="ref")
        assert torch.equal(ring_k["buf"], ring_r["buf"]), f"t={t}"
    assert kernel.launch_count - before == 2 * D
