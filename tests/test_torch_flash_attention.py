"""The port's flash attention (plain PyTorch path, as the CPU runs it)
against the reference's Pallas flash kernel (interpret mode on the CPU)
and its ``attention_ref``, on the shapes of tests/test_kernels.py — GQA,
MHA, a sequence that is no block multiple, MQA — causal and not. Tolerance
5e-6 (float32) and 2e-2 (bfloat16), as the reference's own test. The same
for the rounding order of the bf16 tensor-core kernel
(``ref.attention_kernel_order``) at ragged S, G in {1, 3, 5, 8} and D in
{64, 128}, the launch plan that kernel's wrapper computes, and the limit
``chip_smoke.py`` holds the kernel to against that rounding order."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

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


# (B, S, H, Kh, D): G = H / Kh in {1, 3, 5, 8}, D in {64, 128}, S ragged
ORDER_SHAPES = [
    (1, 200, 5, 1, 64),      # G = 5, two key tiles, the second ragged
    (2, 130, 3, 3, 128),     # G = 1, one row past a tile
    (1, 256, 6, 2, 64),      # G = 3, two whole tiles
    (1, 96, 8, 1, 128),      # G = 8, one ragged tile
]


@pytest.mark.parametrize("b,s,h,kh,d", ORDER_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_order_matches_reference(b, s, h, kh, d, dtype, causal):
    """The tensor-core kernel's rounding order (per 128-key tile, P in the
    inputs' dtype) against the reference's attention_ref and its Pallas
    kernel in interpret mode, at the reference test's tolerances."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(2)
    qj, qt = _pair(rng.standard_normal((b, s, h, d)).astype(np.float32),
                   jdt, tdt)
    kj, kt = _pair(rng.standard_normal((b, s, kh, d)).astype(np.float32),
                   jdt, tdt)
    vj, vt = _pair(rng.standard_normal((b, s, kh, d)).astype(np.float32),
                   jdt, tdt)
    out = ref.attention_kernel_order(qt, kt, vt, causal=causal,
                                     block_k=kernel.TC_BLOCK_K)
    assert out.shape == qt.shape and out.dtype == tdt
    got = _as_np(out)
    want = _as_np(jax_ref(qj, kj, vj, causal=causal))
    assert float(np.max(np.abs(got - want))) < tol
    if causal or s % BLOCK == 0:      # see test_flash_matches_reference
        kern = _as_np(jax_flash(qj, kj, vj, causal=causal, bq=BLOCK,
                                bk=BLOCK))
        assert float(np.max(np.abs(got - kern))) < tol


@pytest.mark.parametrize("d", kernel.TC_HEAD_DIMS)
def test_tensor_core_plan(d):
    """The bf16 kernel's launch plan: its shared memory fits in a block's,
    and a head dim it is not built for is refused. (The tile order and
    the causal tile count live in the CUDA source; the card tests at
    small ragged shapes check them.)"""
    plan = kernel.tc_plan(d)
    assert (plan.block_q, plan.block_k) == (kernel.TC_BLOCK_Q,
                                            kernel.TC_BLOCK_K)
    assert plan.stages >= 2
    assert plan.smem_bytes <= kernel.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="head_dim"):
        kernel.tc_plan(32)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("fault", ["none", "last-bit", "tile-64",
                                   "stale-stage", "late-rows"])
def test_order_limit_separates_faults(fault, d):
    """chip_smoke.order_excess, the elementwise limit of the bf16 kernel
    against attention_kernel_order (causal, S = 384, three 128-key tiles):
    what rounding can give stays within it (the twin itself, a last-bit
    change of every output, the twin over 64-key tiles, whose other running
    maxima round every P afresh), and faults of
    the kind the limit is there for exceed it: the second key tile served
    from a stale ring stage (the first tile's keys), or the rows past 300
    moved by 0.01."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(torch.bfloat16)
               for shape in ((1, 384, 4, d), (1, 384, 2, d), (1, 384, 2, d)))
    bk = kernel.TC_BLOCK_K
    order = ref.attention_kernel_order(q, k, v, causal=True, block_k=bk)
    spread = ref.attention_ref(q.float(), k.float(), v.float().abs(),
                               causal=True)
    if fault == "none":
        out = order
    elif fault == "last-bit":
        out = (order.float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
    elif fault == "tile-64":
        out = ref.attention_kernel_order(q, k, v, causal=True, block_k=64)
    elif fault == "stale-stage":
        ks, vs = k.clone(), v.clone()
        ks[:, bk:2 * bk], vs[:, bk:2 * bk] = k[:, :bk], v[:, :bk]
        out = ref.attention_kernel_order(q, ks, vs, causal=True, block_k=bk)
    else:
        out = order.float()
        out[:, 300:] += 0.01
        out = out.to(torch.bfloat16)
    excess = smoke.order_excess(out, order, spread)
    if fault in ("none", "last-bit", "tile-64"):
        assert excess <= 1, excess
    else:
        assert excess > 1, excess
