"""The port's selective scan (plain PyTorch path, as the CPU runs it)
against the reference's Pallas ssm_scan kernel (interpret mode on the
CPU, bd=16, chunk=16) and its ``ssm_scan_ref``, at the shapes and
tolerance (1e-4, float32) of tests/test_kernels.py, plus a ragged S and Di
that the reference's blocks could not take, bfloat16 inputs (the oracles
within 2e-2; the entry point within one bf16 ulp of the Pallas kernel),
and the kernel wrapper's checks that run without a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref
from repro_torch.kernels.ssm_scan import kernel, ops, ref

SHAPES = [(2, 64, 32, 8), (1, 48, 16, 4), (2, 128, 8, 2)]


def _inputs(b, s, di, n, seed=0):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, di)) - 1, 0).astype(
        np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(np.float32)
    D = rng.standard_normal((di,)).astype(np.float32)
    return x, dt, B, C, A, D


@pytest.mark.parametrize("b,s,di,n", SHAPES)
def test_ssm_scan_matches_reference(b, s, di, n):
    args = _inputs(b, s, di, n)
    before = kernel.launch_count
    got = ops.ssm_scan(*map(torch.from_numpy, args))         # "auto": CPU
    assert kernel.launch_count == before
    assert got.shape == (b, s, di) and got.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, args))
    kern = np.asarray(jax_ssm_scan(*jargs, bd=16, chunk=16))
    ref = np.asarray(jax_ref(*jargs))
    assert float(np.max(np.abs(got.numpy() - kern))) < 1e-4
    assert float(np.max(np.abs(got.numpy() - ref))) < 1e-4


def test_ssm_scan_ragged_matches_reference_oracle():
    """S = 37 and Di = 24: no multiple of a block (the port's kernel takes
    them as they are; the reference's wrapper halves its blocks)."""
    args = _inputs(2, 37, 24, 16, seed=3)
    got = ops.ssm_scan(*map(torch.from_numpy, args)).numpy()
    ref = np.asarray(jax_ref(*map(jnp.asarray, args)))
    assert float(np.max(np.abs(got - ref))) < 1e-4


def _bf16_inputs():
    """x, dt, B, C rounded to bfloat16 (A, D float32), as a bf16 model
    feeds them: (the reference's arrays, the port's tensors)."""
    x, dt, B, C, A, D = _inputs(2, 64, 32, 8, seed=1)
    jx, jdt, jB, jC = (jnp.asarray(t).astype(jnp.bfloat16)
                       for t in (x, dt, B, C))
    tx, tdt, tB, tC = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                       .to(torch.bfloat16) for t in (jx, jdt, jB, jC))
    return ((jx, jdt, jB, jC, jnp.asarray(A), jnp.asarray(D)),
            (tx, tdt, tB, tC, torch.from_numpy(A), torch.from_numpy(D)))


def test_ssm_scan_bf16_matches_reference_oracle():
    """The oracles: the output is cast to bf16, then x * D is added in
    float32 by promotion, in both packages."""
    jargs, targs = _bf16_inputs()
    want = np.asarray(jax_ref(*jargs).astype(jnp.float32))
    got = ref.ssm_scan_ref(*targs)
    assert got.dtype == torch.float32            # bf16 + f32 promotes
    assert float(np.max(np.abs(got.numpy() - want))) < 2e-2


def test_ssm_scan_bf16_matches_reference_kernel():
    """The entry point on the CPU ends as the kernels do: D * x added in
    float32, one cast to bf16. Against the reference's Pallas kernel
    (interpret mode), every output within one bf16 ulp (2^-7 of its
    magnitude)."""
    jargs, targs = _bf16_inputs()
    want = np.asarray(jax_ssm_scan(*jargs, bd=16, chunk=16).astype(
        jnp.float32))
    got = ops.ssm_scan(*targs)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= ulp)


def test_ssm_scan_is_the_sequential_recurrence():
    """The plain version against a float64 numpy loop of the recurrence."""
    x, dt, B, C, A, D = _inputs(1, 20, 6, 4, seed=5)
    h = np.zeros((1, 6, 4))
    want = np.zeros((1, 20, 6))
    for t in range(20):
        h = (np.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[:, :, None] * B[:, t, None, :])
        want[:, t] = np.einsum("bin,bn->bi", h, C[:, t]) + x[:, t] * D
    got = ops.ssm_scan(*map(torch.from_numpy, (x, dt, B, C, A, D)))
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-5


def test_cuda_backend_refuses_cpu_tensors_and_bad_state_sizes():
    x, dt, B, C, A, D = map(torch.from_numpy, _inputs(1, 8, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssm_scan(x, dt, B, C, A, D, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssm_scan_cuda(x, dt, B, C, A, D)
    x, dt, B, C, A, D = map(torch.from_numpy, _inputs(1, 8, 4, 3))
    with pytest.raises(ValueError, match="state size N=3"):
        kernel.ssm_scan_cuda(x, dt, B, C, A, D)
    with pytest.raises(ValueError, match="ssm_scan backend"):
        ops.ssm_scan(x, dt, B, C, A, D, backend="pallas")


def test_loads_only_entry_checks_like_the_scan():
    """The measuring entry point (the kernel's copies alone) takes the
    scan's inputs through the same checks: CPU tensors and an unbuilt N
    are refused before anything is launched, and it counts no launch."""
    before = kernel.launch_count
    x, dt, B, C, A, D = map(torch.from_numpy, _inputs(1, 8, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssm_scan_loads_cuda(x, dt, B, C, A, D)
    x, dt, B, C, A, D = map(torch.from_numpy, _inputs(1, 8, 4, 3))
    with pytest.raises(ValueError, match="state size N=3"):
        kernel.ssm_scan_loads_cuda(x, dt, B, C, A, D)
    assert kernel.launch_count == before
