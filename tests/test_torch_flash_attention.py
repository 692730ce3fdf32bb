"""The port's flash attention (plain PyTorch path, as the CPU runs it)
against the reference's Pallas flash kernel (interpret mode on the CPU)
and its ``attention_ref``, on the shapes of tests/test_kernels.py — GQA,
MHA, a sequence that is no block multiple, MQA — causal and not. Tolerance
5e-6 (float32) and 2e-2 (bfloat16), as the reference's own test. The same
for the rounding order of the bf16 tensor-core kernel
(``ref.attention_kernel_order``) at ragged S, G in {1, 3, 5, 8} and D in
{64, 128}, the launch plan that kernel's wrapper computes, and the limit
``chip_smoke.py`` holds the kernel to against that rounding order. And
the float32 tensor-core kernel's 3xTF32 arithmetic
(``ref.attention_tf32x3_order``): within the float32 tolerance of both
packages' oracles, where one TF32 pass alone is not."""
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


def test_to_tf32_rounds_to_nearest_ties_away():
    """The kernel's TF32 rounding (that of cvt.rna.tf32.f32): 10 mantissa
    bits kept, ties away from zero, the 13 low bits cleared; hi + lo
    carries x to 2^-22."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 3.0e-30, -7.5e8])
    hi = ref.to_tf32(x)
    want = [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0]
    assert hi[:5].tolist() == want
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(10000, dtype=np.float32)
                         * 10.0 ** rng.uniform(-3, 3, 10000).astype(
                             np.float32))
    hi = ref.to_tf32(x)
    lo = ref.to_tf32(x - hi)
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("b,s,h,kh,d", ORDER_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [32, 64])
def test_tf32x3_order_matches_reference(b, s, h, kh, d, causal, block_k):
    """The float32 tensor-core kernel's arithmetic (TF32 halves, three
    products a step rounded toward zero, a key tile of 32 or 64 as the
    kernel takes at D 128 and 64) against the reference's attention_ref
    and its Pallas kernel in interpret mode, at the reference test's float32
    tolerance 5e-6, and against the port's own oracle."""
    jdt, _, tol = DTYPES["float32"]
    rng = np.random.RandomState(4)
    qj, qt = _pair(rng.standard_normal((b, s, h, d)).astype(np.float32),
                   jdt, torch.float32)
    kj, kt = _pair(rng.standard_normal((b, s, kh, d)).astype(np.float32),
                   jdt, torch.float32)
    vj, vt = _pair(rng.standard_normal((b, s, kh, d)).astype(np.float32),
                   jdt, torch.float32)
    out = ref.attention_tf32x3_order(qt, kt, vt, causal=causal,
                                     block_k=block_k)
    assert out.shape == qt.shape and out.dtype == torch.float32
    got = out.numpy()
    assert float(np.max(np.abs(got - _as_np(jax_ref(qj, kj, vj,
                                                    causal=causal))))) < tol
    assert float((out - ref.attention_ref(qt, kt, vt, causal=causal))
                 .abs().max()) < tol
    if causal or s % BLOCK == 0:      # see test_flash_matches_reference
        kern = _as_np(jax_flash(qj, kj, vj, causal=causal, bq=BLOCK,
                                bk=BLOCK))
        assert float(np.max(np.abs(got - kern))) < tol


@pytest.mark.parametrize("d", kernel.TC_HEAD_DIMS)
@pytest.mark.parametrize("rounding", ["rz", "rn"])
def test_one_tf32_pass_misses_the_float32_tolerance(d, rounding):
    """What the split is for: chip_smoke.py holds the float32 kernel to
    attention_ref within FLASH_TOL["float32"] = 1e-5. Three TF32 passes
    stay 4x inside it, their product steps rounded toward zero (as the
    tensor cores round) or to nearest; one pass (a_hi b_hi alone) is 10x
    outside, so a kernel that dropped the compensating products would fail
    there."""
    tol = _chip_smoke().FLASH_TOL["float32"]
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((1, 192, 4, d), (1, 192, 2, d), (1, 192, 2, d)))
    want = ref.attention_ref(q, k, v, causal=True)
    three = ref.attention_tf32x3_order(q, k, v, causal=True,
                                       rounding=rounding)
    one = ref.attention_tf32x3_order(q, k, v, causal=True, passes=1,
                                     rounding=rounding)
    assert float((three - want).abs().max()) < tol / 4
    assert float((one - want).abs().max()) > 10 * tol


def test_round_to_f32_toward_zero_and_to_nearest():
    """The twin's rounding of a fused product step: "rn" as float64 ->
    float32 rounds, "rz" one float32 ulp nearer zero wherever that rounded
    away from zero, for either sign; values float32 holds stay as they
    are."""
    ulp = 2.0 ** -23
    x = torch.tensor([1 + 0.75 * ulp, 1 + 0.25 * ulp, -(1 + 0.75 * ulp),
                      -(1 + 0.25 * ulp), 1 + ulp, -3.0, 0.0],
                     dtype=torch.float64)
    assert ref.round_to_f32(x, "rn").tolist() == [
        1 + ulp, 1.0, -(1 + ulp), -1.0, 1 + ulp, -3.0, 0.0]
    assert ref.round_to_f32(x, "rz").tolist() == [
        1.0, 1.0, -1.0, -1.0, 1 + ulp, -3.0, 0.0]
    with pytest.raises(ValueError, match="rounding"):
        ref.round_to_f32(x, "rd")


@pytest.mark.parametrize("d", kernel.HEAD_DIMS)
def test_route_for_sends_float32_at_64_and_128_to_tf32(d):
    """Which kernel serves a launch: at D 64 and 128 float32 never reaches
    the CUDA-core kernel."""
    tc = d in (64, 128)
    assert kernel.route_for(torch.float32, d) == ("tf32" if tc
                                                  else "cuda_core")
    assert kernel.route_for(torch.bfloat16, d) == ("tc" if tc
                                                   else "cuda_core")
    assert kernel.route_for(torch.float32, d) in kernel.route_counts
    assert kernel.launch_count == sum(kernel.route_counts.values())
