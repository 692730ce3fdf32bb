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
    assert order_err <= smoke.DECODE_ORDER_TOL[dtype], order_err
    assert kernel.launch_count == before + 1


def _held_to_both_plain_versions(q, k, v, kv_len, out):
    """out against decode_attention_ref and the kernel's twin at its split
    plan: NaN in exactly the rows whose kv_len is 0, finite elsewhere and
    within the dtype's tolerances (2e-2 / DECODE_ORDER_TOL in bfloat16;
    5e-6 / TF32X3_ORDER_TOL in float32)."""
    from repro_torch.kernels.decode_attention import ref
    smoke = _chip_smoke()
    dtype = str(q.dtype).split(".")[1]
    order = smoke.decode_order(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len)
    live = kv_len.long() > 0
    assert torch.isnan(out[~live]).all()
    assert torch.isfinite(out[live]).all()
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(torch.isnan(out), torch.isnan(order))
    tol = 2e-2 if dtype == "bfloat16" else 5e-6
    assert (out[live].float() - want[live].float()).abs().max() <= tol
    assert (out[live].float() - order[live].float()).abs().max() <= \
        smoke.DECODE_ORDER_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b,h,kh,s,lens", [
    (2, 2, 2, 90, (5, 90)),           # G = 1, kv_len below one chunk
    (2, 3, 1, 200, (1, 200)),         # G = 3, ragged tiles
    (1, 40, 8, 333, (333,)),          # G = 5
    (3, 8, 1, 1000, (64, 999, 1000)), # G = 8, many splits
    (2, 16, 1, 70, (0, 70)),          # G = 16, kv_len 0 gives NaN
])
def test_decode_tensor_core_kernel_small_shapes(b, h, kh, s, lens, d,
                                                dtype):
    """Both tensor-core split kernels (float32 in 3xTF32, bf16) at every
    head dim, where stages, splits and kv_len end raggedly, against both
    plain versions (kv_len 0: NaN in exactly those rows, as both give)."""
    _need_card()
    from repro_torch.kernels.decode_attention import kernel
    smoke = _chip_smoke()
    q, k, v, kv_len = smoke.decode_inputs(b, h, kh, d, s, lens, dtype)
    out = kernel.decode_attention_cuda(q, k, v, kv_len)
    _held_to_both_plain_versions(q, k, v, kv_len, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_decode_kernel_reads_strided_cache_views(d, dtype):
    """k and v as views: the model cache's [B, S, Kh, D] through a
    transpose, and keys sliced out of a longer cache, each held to both
    plain versions."""
    _need_card()
    from repro_torch.kernels.decode_attention import kernel
    smoke = _chip_smoke()
    b, h, kh, s = 3, 12, 4, 300
    q, k, v, kv_len = smoke.decode_inputs(b, h, kh, d, s + 60, (7, 150, 300),
                                          dtype)
    views = (tuple(t.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :s]
                   for t in (k, v)),
             (k[:, :, 40:40 + s], v[:, :, 10:10 + s]))
    for kv in views:
        out = kernel.decode_attention_cuda(q, *kv, kv_len)
        _held_to_both_plain_versions(q, *kv, kv_len, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_bf16_refuses_unaligned_rows(dtype):
    """Rows the 16-byte copies cannot take: strides off whole 16 bytes
    (bf16 rows of 68 elements) or a start off a 16-byte boundary (float32
    rows one element in). (The name is kept from when only the bf16
    kernel copied 16 bytes at a time.)"""
    _need_card()
    from repro_torch.kernels.decode_attention import kernel
    q = torch.randn(1, 4, 64, device="cuda", dtype=dtype)
    k = torch.randn(1, 1, 40, 68, device="cuda", dtype=dtype)
    rows = k[..., :64] if dtype == torch.bfloat16 else k[..., 1:65]
    with pytest.raises(ValueError, match="16-byte"):
        kernel.decode_attention_cuda(q, rows, rows,
                                     torch.tensor([40], device="cuda"))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_ssm_scan_state_sizes_and_ragged_widths(n):
    """Every compiled N, at a Di that is no multiple of the block and an
    S that is no multiple of the tile."""
    _need_card()
    smoke = _chip_smoke()
    err, _ = smoke.check_ssm(3, 77, 200, n, "float32")
    assert err <= smoke.SSM_TOL["float32"], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n", [
    (2, 1, 128, 16),      # one step: one partial tile
    (1, 17, 200, 16),     # one step past a float32 tile; ragged Di
    (3, 1000, 77, 8),     # many tiles and ring turns; rows off 16 bytes
    (2, 33, 4100, 4),     # one step past a bf16 tile; bf16 rows alternate
    (1, 65, 130, 2),      # Di two channels past a block
])
def test_ssm_scan_tile_and_stage_edges(b, s, di, n, dtype):
    """The staged kernel where its tiles, ring stages and 16-byte copies
    end: S of 1, 17, 33, 65 and 1000 steps (tiles of 16 steps in float32,
    32 in bfloat16; a ring of 4), Di off the 128-channel block and off a
    16-byte row."""
    _need_card()
    from repro_torch.kernels.ssm_scan import kernel
    smoke = _chip_smoke()
    if dtype == "float32":
        err, _ = smoke.check_ssm(b, s, di, n, dtype)
        assert err <= smoke.SSM_TOL[dtype], err
    else:
        # the reference test's distributions give outputs past 16, where
        # the early-cast oracle is a bf16 ulp (0.125) off: the kernel's
        # own order is the yardstick
        inputs = smoke.ssm_inputs(b, s, di, n, dtype)
        excess = smoke.ssm_order_excess(kernel.ssm_scan_cuda(*inputs),
                                        inputs)
        assert excess <= 1, excess


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n", [(2, 150, 300, 16), (1, 1000, 77, 8)])
def test_ssm_scan_loads_only_entry_moves_the_scans_data(b, s, di, n, dtype):
    """The measuring entry point reads x, dt, B and C and writes y where the
    scan does: y = x + dt + B[..., 0] + C[..., 0] in float32, one cast, at
    every step and channel (ragged S and Di included); no launch counted."""
    _need_card()
    import torch
    from repro_torch.kernels.ssm_scan import kernel
    smoke = _chip_smoke()
    x, dt, B, C, A, D = smoke.ssm_inputs(b, s, di, n, dtype)
    before = kernel.launch_count
    out = kernel.ssm_scan_loads_cuda(x, dt, B, C, A, D)
    want = (x.float() + dt.float() + B[..., :1].float()
            + C[..., :1].float()).to(x.dtype)
    torch.cuda.synchronize()
    assert kernel.launch_count == before
    assert torch.equal(out, want)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_decode_loads_only_entry_runs_uncounted(d):
    """The float32 kernel's measuring entry point (its copies, barriers
    and partials alone) launches at every head dim on ragged kv_len and
    strided views, gives finite values of the output's shape, and counts
    no launch."""
    _need_card()
    from repro_torch.kernels.decode_attention import kernel
    smoke = _chip_smoke()
    q, k, v, kv_len = smoke.decode_inputs(2, 10, 2, d, 700, (3, 700),
                                          "float32")
    kc = k.transpose(1, 2).contiguous().transpose(1, 2)
    before = kernel.launch_count
    out = kernel.decode_attention_loads_cuda(q, kc, v, kv_len)
    torch.cuda.synchronize()
    assert kernel.launch_count == before
    assert out.shape == q.shape and torch.isfinite(out).all()


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
