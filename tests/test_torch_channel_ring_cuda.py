"""The fused CUDA channel-ring commit against its plain PyTorch path, bit
for bit, on the card: random tick traffic (drops, in-slot collisions, 2*D
ticks at D=256, B=16) through the sporades, mandator, paxos (plain and
Mandator mode) and additive layouts,
and adversarial traffic (a ring holding cells below -1 and additive -0.0,
expanded payloads, most sends masked out). The layouts and the traffic are
chip_smoke.py's own (``layouts``, ``random_sends``, ``adversarial_ring``),
so the two checks cannot drift apart. Skips without a CUDA device; run it
on the card with

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


@pytest.mark.parametrize("layout", ["sporades", "mandator", "paxos",
                                    "mandator-paxos", "additive"])
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


@pytest.mark.parametrize("layout", ["sporades", "mandator", "paxos",
                                    "mandator-paxos", "additive"])
def test_kernel_matches_plain_on_adversarial_traffic(layout):
    """Masked-out sends over cells below -1, additive cells holding -0.0
    and expanded payloads: the bits of every cell (the sign of a zero
    too) equal the plain path's after every tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core import channel as ch

    smoke = _chip_smoke()
    D, N = smoke.D, 5
    spec, names = smoke.layouts()[layout]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    ring_k = smoke.adversarial_ring(spec, N, gen, ch)
    ring_r = {"buf": ring_k["buf"].clone()}
    for t in range(64):
        sends, drop = smoke.random_sends(spec, names, N, gen, ch,
                                         expand=t % 2 == 0, p_mask=0.2)
        ring_k = ch.ring_commit(spec, ring_k, t, sends, drop=drop,
                                backend="cuda")
        ring_r = ch.ring_commit(spec, ring_r, t, sends, drop=drop,
                                backend="ref")
        assert torch.equal(ring_k["buf"].view(torch.int32),
                           ring_r["buf"].view(torch.int32)), f"t={t}"


def test_fused_commit_refuses_before_launching():
    """On CUDA tensors too, a payload of another dtype, more than
    MAX_ENTRIES sends and an additive channel sent twice raise, and
    nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core import channel as ch
    from repro_torch.kernels.channel_ring import kernel

    smoke = _chip_smoke()
    spec, names = smoke.layouts()["additive"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    ring = ch.make_ring(spec, 8, 5, smoke.B, torch.device("cuda"))
    sends, drop = smoke.random_sends(spec, names, 5, gen, ch)
    before = kernel.launch_count
    bad = [s._replace(payload=s.payload.double()) for s in sends]
    with pytest.raises(TypeError, match="float32"):
        ch.ring_commit(spec, ring, 0, bad, drop=drop, backend="cuda")
    with pytest.raises(ValueError, match="at most"):
        ch.ring_commit(spec, ring, 0, [sends[0]] * 17, drop=drop,
                       backend="cuda")
    with pytest.raises(ValueError, match="additive"):
        ch.ring_commit(spec, ring, 0, sends + [sends[1]], drop=drop,
                       backend="cuda")
    assert kernel.launch_count == before
