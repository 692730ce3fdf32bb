"""The port's RMSNorm (plain PyTorch path, as the CPU runs it) against the
reference's Pallas RMSNorm kernel (interpret mode on the CPU), on the
shapes, dtypes and residual cases of tests/test_kernels.py, at its
tolerances: 1e-5 (float32) and 3e-2 (bfloat16). Inputs come from a numpy
seed and go through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro_torch.kernels.rmsnorm import kernel, ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _pair(a: np.ndarray, jdt, tdt):
    """One array in both packages, rounded once to the dtype."""
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(4, 16, 64), (3, 7, 32), (2, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_matches_reference(shape, dtype, residual):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(0)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), jdt, tdt)
    rj, rt = _pair(rng.standard_normal(shape).astype(np.float32), jdt, tdt)
    wj, wt = _pair(rng.standard_normal(shape[-1:]).astype(np.float32), jdt,
                   tdt)
    if not residual:
        rj = rt = None
    before = kernel.launch_count
    out = ops.rmsnorm(xt, wt, eps=1e-5, residual=rt)          # "auto": CPU
    ref = jax_rmsnorm(xj, wj, eps=1e-5, residual=rj)
    assert out.shape == xt.shape and out.dtype == tdt
    err = float(np.max(np.abs(_as_np(out) - _as_np(ref))))
    assert err < tol, err
    same = ops.rmsnorm(xt, wt, eps=1e-5, residual=rt, backend="ref")
    assert torch.equal(same, out)
    assert kernel.launch_count == before


def test_rmsnorm_ref_is_fp32_then_cast():
    """The kernel's order: statistics and the multiply by w in fp32, one
    cast at the end (the plain model path casts before multiplying)."""
    x = torch.randn(5, 24, dtype=torch.float64)
    w = torch.randn(24, dtype=torch.float64)
    want = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * w
    got = rmsnorm_ref(x.to(torch.bfloat16), w.float())
    assert got.dtype == torch.bfloat16
    assert torch.allclose(got.double(), want, atol=3e-2)


def test_cuda_backend_refuses_cpu_tensors():
    x, w = torch.randn(4, 8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(x, w, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.rmsnorm_cuda(x, w)
    with pytest.raises(ValueError, match="rmsnorm backend"):
        ops.rmsnorm(x, w, backend="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_keeps_every_config_row_in_registers(dtype):
    """For every configuration's d_model, at a prefill's and a decode
    step's row counts: the plan's threads hold whole 16-byte vectors that
    cover the row, within the register cap and the CTA's threads."""
    from repro_torch.configs import get_config, list_archs
    widths = {get_config(a).d_model for a in list_archs()}
    assert min(widths) == 576 and max(widths) == 8192
    for d in sorted(widths):
        for n in (1, 4, 8192):
            p = kernel.plan(n, d, dtype)
            assert p.vec * dtype.itemsize == 16
            assert p.threads % 32 == 0 and p.threads <= kernel.MAX_THREADS
            assert p.in_registers and p.per_thread <= kernel.MAX_VEC
            assert p.threads * p.per_thread * p.vec >= d
            assert (p.threads * (p.per_thread - 1)) * p.vec < d
            if n == 8192 and d == 576:
                assert p.threads == 32                  # a warp a row
            if n == 4:
                assert p.threads == min(kernel.MAX_THREADS,
                                        32 * -(-d * dtype.itemsize // 512))


def test_plan_decode_and_fallbacks():
    """The decode step's [4, 576] float32: one CTA per row, one float4 a
    thread (144 vectors over 160 threads). Single-element vectors where
    16 bytes do not divide the row or a pointer; past the register cap a
    loop."""
    p = kernel.plan(4, 576, torch.float32)
    assert (p.threads, p.vec, p.per_thread) == (160, 4, 1)
    assert kernel.plan(4, 100, torch.bfloat16, 2).vec == 1
    assert not kernel.plan(4, 40000, torch.float32).in_registers
    x = torch.zeros(4 * 576 + 1)
    w = torch.ones(576)
    assert kernel.vector_bytes(576, x[:-1].view(4, 576), w) == 16
    assert kernel.vector_bytes(576, x[1:].view(4, 576), w) == 4
    assert kernel.vector_bytes(100, torch.zeros(2, 100, dtype=torch.bfloat16),
                               torch.ones(100)) == 2
    assert kernel.vector_bytes(96, torch.zeros(2, 96, dtype=torch.bfloat16),
                               torch.ones(97)[1:]) == 2


@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_ref_with_bf16_weight_equals_widened(residual):
    """The kernel reads a bf16 w in bf16 and widens it in registers; the
    plain version with that bf16 w equals it with w.float(), exactly."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((6, 96)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((6, 96)).astype(np.float32))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(96).astype(
        np.float32)).to(torch.bfloat16)
    res = r if residual else None
    for xt in (x, x.to(torch.bfloat16)):
        rt = None if res is None else res.to(xt.dtype)
        a = rmsnorm_ref(xt, w, residual=rt)
        b = rmsnorm_ref(xt, w.float(), residual=rt)
        assert a.dtype == xt.dtype and torch.equal(a, b)
