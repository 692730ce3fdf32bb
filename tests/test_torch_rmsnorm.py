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
