"""The CUDA selective-scan and flash-decoding kernels against their plain
PyTorch versions on the card, at the shapes and tolerances of
chip_smoke.py's ssm-kernel and decode-kernel phases (its own cases and
helpers, so the two checks cannot drift apart), plus the backend rule and
the strided cache layout on CUDA tensors. Skips without a CUDA device; run
it on the card with

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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("case", range(4))
def test_ssm_scan_kernel_matches_plain(case):
    _need_card()
    from repro_torch.kernels.ssm_scan import kernel
    smoke = _chip_smoke()
    _, b, s, di, n, dtype = smoke.SSM_CASES[case]
    before = kernel.launch_count
    err, _ = smoke.check_ssm(b, s, di, n, dtype)
    assert err <= smoke.SSM_TOL[dtype], err
    assert kernel.launch_count == before + 1


@pytest.mark.parametrize("case", range(6))
def test_decode_kernel_matches_plain(case):
    _need_card()
    from repro_torch.kernels.decode_attention import kernel
    smoke = _chip_smoke()
    _, b, h, kh, d, s, lens, dtype, tol = smoke.DECODE_CASES[case]
    before = kernel.launch_count
    err, order_err, _ = smoke.check_decode(b, h, kh, d, s, lens, dtype)
    assert err <= tol, err
    if dtype == "bfloat16":
        assert order_err <= smoke.DECODE_ORDER_TOL, order_err
    assert kernel.launch_count == before + 1


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b,h,kh,s,lens", [
    (2, 3, 1, 200, (1, 200)),         # G = 3, ragged tiles
    (1, 40, 8, 333, (333,)),          # G = 5
    (3, 8, 1, 1000, (64, 999, 1000)), # G = 8, many splits
    (2, 16, 1, 70, (0, 70)),          # G = 16, kv_len 0 gives NaN
])
def test_decode_tensor_core_kernel_small_shapes(b, h, kh, s, lens, d):
    """The bf16 tensor-core split kernel at every head dim, against both
    plain versions (kv_len 0: NaN in exactly those rows, as both give)."""
    _need_card()
    from repro_torch.kernels.decode_attention import kernel, ref
    smoke = _chip_smoke()
    q, k, v, kv_len = smoke.decode_inputs(b, h, kh, d, s, lens, "bfloat16")
    out = kernel.decode_attention_cuda(q, k, v, kv_len)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = kernel.bf16_ctas_per_sm(d, 0)
    _, chunk = kernel.bf16_plan(s, b * kh, sms, per_sm)
    order = ref.decode_attention_kernel_order(q, k, v, kv_len, chunk=chunk)
    want = ref.decode_attention_ref(q, k, v, kv_len)
    live = kv_len.long() > 0
    assert torch.isnan(out[~live]).all()
    assert torch.isfinite(out[live]).all()
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(torch.isnan(out), torch.isnan(order))
    assert (out[live].float() - want[live].float()).abs().max() <= 2e-2
    assert (out[live].float() - order[live].float()).abs().max() <= \
        smoke.DECODE_ORDER_TOL


def test_decode_bf16_refuses_unaligned_rows():
    _need_card()
    from repro_torch.kernels.decode_attention import kernel
    q = torch.randn(1, 4, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 1, 40, 68, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        kernel.decode_attention_cuda(q, k[..., :64], k[..., :64],
                                     torch.tensor([40], device="cuda"))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_ssm_scan_state_sizes_and_ragged_widths(n):
    """Every compiled N, at a Di that is no multiple of the block and an
    S that is no multiple of the tile."""
    _need_card()
    smoke = _chip_smoke()
    err, _ = smoke.check_ssm(3, 77, 200, n, "float32")
    assert err <= smoke.SSM_TOL["float32"], err


def test_auto_backend_and_cache_layout():
    _need_card()
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    smoke = _chip_smoke()
    before = sk.launch_count
    sops.ssm_scan(*smoke.ssm_inputs(1, 40, 64, 8, "float32"))
    assert sk.launch_count == before + 1
    q, k, v, kv_len = smoke.decode_inputs(2, 8, 2, 32, 100, (1, 100),
                                          "float32")
    kc = k.transpose(1, 2).contiguous()              # [B, S, Kh, D]
    vc = v.transpose(1, 2).contiguous()
    before = dk.launch_count
    out = dops.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                kv_len)
    assert dk.launch_count == before + 1
    want = dref.decode_attention_ref(q, k, v, kv_len)
    assert (out - want).abs().max().item() <= 5e-6
    lens = torch.tensor([0, 100], dtype=kv_len.dtype, device="cuda")
    part = dops.decode_attention(q, k, v, lens)
    want = dref.decode_attention_ref(q, k, v, lens)
    assert torch.isnan(part[0]).all() and torch.isfinite(part[1]).all()
    assert torch.equal(torch.isnan(part), torch.isnan(want))
    assert (part[1] - want[1]).abs().max().item() <= 5e-6
    zero = dops.decode_attention(q, k, v, torch.zeros_like(kv_len))
    assert torch.isnan(zero).all()
