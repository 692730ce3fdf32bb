"""The CUDA RMSNorm and flash attention kernels against their plain
PyTorch versions on the card, at the shapes and tolerances of
chip_smoke.py's model-kernels phase (its own cases and helpers, so the two
checks cannot drift apart), plus the backend rule on CUDA tensors. Skips
without a CUDA device; run it on the card with

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


_N_RMS = len(_chip_smoke().RMS_CASES)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("case", range(_N_RMS))
def test_rmsnorm_kernel_matches_plain(case):
    _need_card()
    from repro_torch.kernels.rmsnorm import kernel
    smoke = _chip_smoke()
    dtype = smoke.RMS_CASES[case][2]
    before = kernel.launch_count
    err, _ = smoke.check_rmsnorm(*smoke.RMS_CASES[case])
    assert err <= smoke.RMS_TOL[dtype], err
    assert kernel.launch_count == before + 1


@pytest.mark.parametrize("case", range(8))
def test_flash_kernel_matches_plain(case):
    _need_card()
    from repro_torch.kernels.flash_attention import kernel
    smoke = _chip_smoke()
    _, b, s, h, kh, d, causal, dtype = smoke.FLASH_CASES[case]
    before = kernel.launch_count
    err, order_err, excess, _ = smoke.check_flash(b, s, h, kh, d, causal,
                                                  dtype)
    assert err <= smoke.FLASH_TOL[dtype], err
    if dtype == "bfloat16":
        assert excess <= 1, (excess, order_err)
    elif d in kernel.TC_HEAD_DIMS:
        assert order_err <= smoke.TF32X3_ORDER_TOL, order_err
    assert kernel.launch_count == before + 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,s,h,kh,causal", [
    (1, 77, 4, 2, True),        # one ragged tile
    (2, 300, 6, 3, False),      # ragged, three key tiles
    (1, 256, 5, 1, True),       # G = 5, tiles on the diagonal only
    (1, 129, 8, 8, True),       # MHA, one row past a tile
])
def test_flash_tensor_core_kernel_small_shapes(b, s, h, kh, causal, d):
    """The bf16 tensor-core kernel at small ragged shapes, against both
    plain versions."""
    _need_card()
    smoke = _chip_smoke()
    err, order_err, excess, _ = smoke.check_flash(b, s, h, kh, d, causal,
                                                  "bfloat16")
    assert err <= smoke.FLASH_TOL["bfloat16"], err
    assert excess <= 1, (excess, order_err)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,s,h,kh,causal", [
    (1, 77, 4, 2, True),        # one ragged tile
    (2, 300, 6, 3, False),      # non-causal, ragged, several key tiles
    (1, 256, 5, 1, True),       # H / Kh = 5
    (1, 129, 8, 8, True),       # H / Kh = 1, Sq one row past a query tile
    (3, 1, 2, 1, True),         # one position
    (2, 100, 10, 2, False),     # H / Kh = 5, non-causal, Sq < one tile
])
def test_flash_tf32_kernel_small_shapes(b, s, h, kh, causal, d):
    """The float32 3xTF32 tensor-core kernel at small ragged shapes: it is
    the kernel that runs (check_flash reads the route count), within the
    float32 tolerance of the plain version and within TF32X3_ORDER_TOL of
    its rounding twin, element by element."""
    _need_card()
    smoke = _chip_smoke()
    err, order_err, _, _ = smoke.check_flash(b, s, h, kh, d, causal,
                                             "float32")
    assert err <= smoke.FLASH_TOL["float32"], err
    assert order_err <= smoke.TF32X3_ORDER_TOL, order_err


@pytest.mark.parametrize("n,d", [(1, 32), (5, 1000), (2000, 576),
                                 (3, 40000), (1100, 99)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plans_and_ragged_rows(n, d, dtype):
    """Every shape of plan: a warp per row, a CTA per row, a row looped
    over (40000 is past the registers), and D that no vector divides."""
    _need_card()
    smoke = _chip_smoke()
    for residual in (False, True):
        err, _ = smoke.check_rmsnorm(n, d, dtype, residual, dtype)
        assert err <= smoke.RMS_TOL[dtype], (residual, err)


def test_auto_backend_launches_kernels_on_cuda_tensors():
    _need_card()
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ops as rops
    x = torch.randn(2, 3, 64, device="cuda")
    w = torch.ones(64, device="cuda")
    before = rk.launch_count
    rops.rmsnorm(x, w)
    assert rk.launch_count == before + 1
    q = torch.randn(1, 40, 4, 32, device="cuda")
    k = torch.randn(1, 40, 2, 32, device="cuda")
    before = fk.launch_count
    core = fk.route_counts["cuda_core"]
    fops.flash_attention(q, k, k)
    assert fk.launch_count == before + 1
    assert fk.route_counts["cuda_core"] == core + 1      # float32, D = 32
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_cuda(torch.randn(1, 8, 2, 48, device="cuda"),
                                torch.randn(1, 8, 1, 48, device="cuda"),
                                torch.randn(1, 8, 1, 48, device="cuda"))
