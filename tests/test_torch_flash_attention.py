"""The port's flash attention (plain PyTorch path, as the CPU runs it)
against the reference's Pallas flash kernel (interpret mode on the CPU)
and its ``attention_ref``, on the shapes of tests/test_kernels.py — GQA,
MHA, a sequence that is no block multiple, MQA — causal and not. Tolerance
5e-6 (float32) and 2e-2 (bfloat16), as the reference's own test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SHAPES = [
    (2, 128, 4, 2, 32),
    (1, 256, 8, 8, 64),
    (2, 96, 6, 3, 16),      # no multiple of the reference's block
    (1, 64, 4, 1, 32),      # MQA
]
BLOCK = 64                  # the reference test's bq = bk


def _pair(a: np.ndarray, jdt, tdt):
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("b,s,h,kh,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(b, s, h, kh, d, dtype, causal):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(1)
    qj, qt = _pair(rng.standard_normal((b, s, h, d)).astype(np.float32),
                   jdt, tdt)
    kj, kt = _pair(rng.standard_normal((b, s, kh, d)).astype(np.float32),
                   jdt, tdt)
    vj, vt = _pair(rng.standard_normal((b, s, kh, d)).astype(np.float32),
                   jdt, tdt)
    before = kernel.launch_count
    out = ops.flash_attention(qt, kt, vt, causal=causal)       # "auto": CPU
    assert out.shape == qt.shape and out.dtype == tdt
    assert kernel.launch_count == before
    got = _as_np(out)
    ref = _as_np(jax_ref(qj, kj, vj, causal=causal))
    assert float(np.max(np.abs(got - ref))) < tol
    # the reference's kernel pads S to its block with zero keys, which the
    # causal mask hides; without it the padding would be attended to, so
    # the kernel is compared where nothing is padded or the mask is on
    if causal or s % BLOCK == 0:
        kern = _as_np(jax_flash(qj, kj, vj, causal=causal, bq=BLOCK,
                                bk=BLOCK))
        assert float(np.max(np.abs(got - kern))) < tol


def test_cuda_backend_refuses_cpu_tensors():
    q = torch.randn(1, 16, 2, 16)
    k = v = torch.randn(1, 16, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v)
