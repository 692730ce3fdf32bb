"""The port's flash-decoding (plain PyTorch path, as the CPU runs it)
against the reference's Pallas decode kernel (interpret mode on the CPU,
bs=64) and its ``decode_attention_ref``, at the shapes and tolerance (5e-6,
float32) of tests/test_kernels.py — GQA, MHA, MQA, ragged ``kv_len`` —
plus the dense-path twin of that file's model check: the port's cache
attention (dense and chunked, with ``kv_len``) against the port's decode
attention on the model cache's [B, S, Kh, D] layout seen as a transposed
view, and the kernel wrapper's checks that run without a card. The same
for the rounding order of the bf16 tensor-core kernel
(``ref.decode_attention_kernel_order``) at G in {1, 3, 5, 8} and D in
{64, 128}, for the 3xTF32 arithmetic of the float32 tensor-core kernel
(``ref.decode_attention_tf32x3_order``) at G in {1, 3, 5, 8, 16} and D in
{16, 64, 128} on both cache layouts, and for the split plan of both
kernels (``kernel.wave_plan``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.models.layers import chunked_attention, dense_attention

TOL = 5e-6
STAGE = 64      # keys a ring stage of both split kernels (kernel.stage())
SHAPES = [
    (2, 4, 2, 256, 32),
    (1, 8, 8, 128, 64),     # MHA
    (2, 4, 1, 512, 16),     # MQA
]


def _inputs(b, h, kh, s, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    kv_len = (np.arange(1, b + 1) * (s // (b + 1) + 1)).astype(np.int32)
    return q, k, v, kv_len


@pytest.mark.parametrize("b,h,kh,s,d", SHAPES)
def test_decode_attention_matches_reference(b, h, kh, s, d):
    args = _inputs(b, h, kh, s, d)
    before = kernel.launch_count
    got = ops.decode_attention(*map(torch.from_numpy, args))  # "auto": CPU
    assert kernel.launch_count == before
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, args))
    kern = np.asarray(jax_decode(*jargs, bs=64))
    ref = np.asarray(jax_ref(*jargs))
    assert float(np.max(np.abs(got.numpy() - kern))) < TOL
    assert float(np.max(np.abs(got.numpy() - ref))) < TOL


def test_decode_attention_bf16_matches_reference_oracle():
    """bfloat16 q, k, v: both oracles round the scores and the
    probabilities to bf16 at the same places; 2e-2 as the reference's
    bf16 kernel tests."""
    q, k, v, kv_len = _inputs(2, 4, 2, 256, 32, seed=2)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jax_ref(jq, jk, jv, jnp.asarray(kv_len))
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                  .to(torch.bfloat16) for t in (jq, jk, jv))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    assert got.dtype == torch.bfloat16
    assert float(np.max(np.abs(got.float().numpy() - want))) < 2e-2


def test_decode_attention_matches_model_decode_path():
    """The twin of tests/test_kernels.py::
    test_decode_attention_matches_model_decode_path on the port: the
    model's cache attention with kv_len (dense and chunked) against
    decode attention on the same cache read through a transposed view."""
    b, h, kh, s, d = 2, 4, 2, 64, 16
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kh, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kh, d)).astype(np.float32))
    kv_len = torch.tensor([40, 64], dtype=torch.int32)
    r = ops.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                             kv_len)
    a = dense_attention(q, k, v, causal=False, kv_len=kv_len)[:, 0]
    c = chunked_attention(q, k, v, causal=False, chunk=16,
                          kv_len=kv_len)[:, 0]
    assert float((a - r).abs().max()) < TOL
    assert float((c - r).abs().max()) < TOL
    want = np.asarray(jax_ref(jnp.asarray(q[:, 0].numpy()),
                              jnp.asarray(k.transpose(1, 2).numpy()),
                              jnp.asarray(v.transpose(1, 2).numpy()),
                              jnp.asarray(kv_len.numpy())))
    assert float(np.max(np.abs(r.numpy() - want))) < TOL


_cuda = kernel.decode_attention_cuda


@pytest.mark.parametrize("call,exc,msg", [
    pytest.param(lambda q, k, v, n: _cuda(q[None], k, v, n), ValueError,
                 r"\[B, H, D\]", id="q not 3-D"),
    pytest.param(lambda q, k, v, n: _cuda(q, k, v[:, :, :16], n),
                 ValueError, r"\[B, H, D\]", id="k, v shapes differ"),
    pytest.param(lambda q, k, v, n: _cuda(q[:, :3].contiguous(), k, v, n),
                 ValueError, "H % Kh", id="H % Kh"),
    pytest.param(lambda q, k, v, n: _cuda(q[..., :8].contiguous(),
                                          k[..., :8], v[..., :8], n),
                 ValueError, "head_dim", id="head_dim"),
    pytest.param(lambda q, k, v, n: _cuda(
        *map(torch.from_numpy, _inputs(2, 17, 1, 32, 16))), ValueError,
        "at most 16", id="G > 16"),
    pytest.param(lambda q, k, v, n: _cuda(q, k, v, n[:1]), ValueError,
                 "kv_len", id="kv_len shape"),
    pytest.param(lambda q, k, v, n: _cuda(q, k, v, n), ValueError, "CUDA",
                 id="cpu tensors"),
    pytest.param(lambda q, k, v, n: ops.decode_attention(q, k, v, n,
                                                         backend="cuda"),
                 ValueError, "CUDA", id="ops backend cuda"),
    pytest.param(lambda q, k, v, n: kernel.decode_attention_loads_cuda(
        *(t.to(torch.bfloat16) for t in (q, k, v)), n), TypeError,
        "float32 only", id="loads-only bf16"),
])
def test_wrapper_refuses_on_the_cpu(call, exc, msg):
    """Every refusal of the wrapper (and of ``ops`` asked for the kernel)
    that comes before a card is needed raises, and launches nothing."""
    q, k, v, kv_len = map(torch.from_numpy, _inputs(2, 4, 2, 32, 16))
    before = kernel.launch_count
    with pytest.raises(exc, match=msg):
        call(q, k, v, kv_len)
    assert kernel.launch_count == before


# (B, H, Kh, S, D): G = H / Kh in {1, 3, 5, 8}, D in {64, 128}
ORDER_SHAPES = [
    (2, 3, 3, 128, 64),      # G = 1
    (2, 6, 2, 256, 128),     # G = 3
    (1, 10, 2, 192, 64),     # G = 5
    (3, 8, 1, 256, 128),     # G = 8
]


@pytest.mark.parametrize("b,h,kh,s,d", ORDER_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_order_matches_reference(b, h, kh, s, d, dtype):
    """The bf16 kernel's rounding order (splits of the kernel's plan on a
    132-SM card, which at these sizes is one split per 64-key tile at any
    occupancy; 64-key tiles, four 16-key warp slices, P in the inputs'
    dtype) against the reference's oracle and its Pallas kernel (interpret
    mode, bs=64), ragged kv_len; 5e-6 in float32, 2e-2 in bfloat16."""
    q, k, v, kv_len = _inputs(b, h, kh, s, d, seed=3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = TOL if dtype == "float32" else 2e-2
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for t in (jq, jk, jv))
    _, chunk = kernel.wave_plan(s, b * kh, 132, 1, STAGE)
    got = ref.decode_attention_kernel_order(tq, tk, tv,
                                            torch.from_numpy(kv_len),
                                            chunk=chunk, tile=STAGE)
    assert got.shape == (b, h, d) and got.dtype == tq.dtype
    got = got.float().numpy()
    jl = jnp.asarray(kv_len)
    want = np.asarray(jax_ref(jq, jk, jv, jl).astype(jnp.float32))
    kern = np.asarray(jax_decode(jq, jk, jv, jl, bs=64).astype(jnp.float32))
    assert float(np.max(np.abs(got - want))) < tol
    assert float(np.max(np.abs(got - kern))) < tol


def test_kernel_order_zero_length_gives_zeros():
    """A row with kv_len 0 has no key to attend to: the kernel-order twin
    gives NaN there, as the oracle's softmax over nothing does, and finite
    values, equal to the oracle's within 5e-6, in the other rows. (The
    name is kept from when the twin, like the kernel, gave zeros.)"""
    q, k, v, _ = map(torch.from_numpy, _inputs(3, 4, 2, 100, 16))
    kv_len = torch.tensor([0, 37, 0])
    out = ref.decode_attention_kernel_order(q, k, v, kv_len, chunk=64)
    dead = (kv_len == 0)[:, None, None].expand_as(out)
    assert torch.isnan(out[dead]).all()
    assert torch.isfinite(out[~dead]).all()
    want = ref.decode_attention_ref(q, k, v, kv_len)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert (out[~dead] - want[~dead]).abs().max() < 5e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_length_rows_are_nan_as_in_the_oracle(dtype):
    """kv_len = 0: the port's plain version and the reference's oracle
    both give NaN, in exactly the same positions (the rows whose kv_len is
    0), and agree elsewhere."""
    q, k, v, _ = _inputs(4, 6, 2, 96, 32, seed=5)
    kv_len = np.array([0, 96, 0, 11], np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    want = np.asarray(jax_ref(jq, jk, jv, jnp.asarray(kv_len))
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for t in (jq, jk, jv))
    got = ops.decode_attention(tq, tk, tv,
                               torch.from_numpy(kv_len)).float().numpy()
    dead = np.broadcast_to((kv_len == 0)[:, None, None], got.shape)
    np.testing.assert_array_equal(np.isnan(got), dead)
    np.testing.assert_array_equal(np.isnan(want), dead)
    tol = TOL if dtype == "float32" else 2e-2
    assert float(np.max(np.abs(got[~dead] - want[~dead]))) < tol


@pytest.mark.parametrize("per_sm", [1, 2, 5, 8, 10])
@pytest.mark.parametrize("tile", [STAGE, 32])
def test_wave_plan_covers_the_cache_in_one_wave(tile, per_sm):
    """The split plan of both kernels (their ``STAGE``-key ring stages, and
    another stage size), for a card that holds ``per_sm`` CTAs per SM (the
    occupancy calculator's count, read on the card: 1, 2, 5 for the
    float32 kernel at D 128, 64, 16; 10, 8, 2 for bf16 at D 16, 32, 128):
    the splits' chunks are whole ring stages, cover the cache with none
    empty, and launch no more CTAs than the card holds at once (unless one
    split is already more)."""
    for s in (1, tile - 1, tile, 1000, 2048, 8192):
        for ctas in (1, 12, 64, 4096):
            splits, chunk = kernel.wave_plan(s, ctas, 132, per_sm, tile)
            assert chunk % tile == 0
            assert (splits - 1) * chunk < s <= splits * chunk
            assert splits == 1 or ctas * splits <= per_sm * 132
    # qwen3-14b's full cache in bf16 at two CTAs per SM: 64 CTAs a split,
    # 4 splits = one wave of 264 slots (the bf16 plan, unchanged)
    assert kernel.wave_plan(8192, 64, 132, 2, STAGE) == (4, 2048)


# (B, H, Kh, S, D, kv_len): G = H / Kh in {1, 3, 5, 8, 16}, D in
# {16, 64, 128}, ragged kv_len (one below a stage, several splits)
TF32_SHAPES = [
    (2, 3, 3, 200, 64, (1, 200)),        # G = 1
    (2, 6, 2, 256, 16, (37, 256)),       # G = 3
    (1, 10, 2, 192, 128, (150,)),        # G = 5
    (3, 8, 1, 256, 64, (64, 255, 9)),    # G = 8
    (1, 16, 1, 128, 128, (100,)),        # G = 16
]


@pytest.mark.parametrize("layout", ["reference", "cache"])
@pytest.mark.parametrize("b,h,kh,s,d,lens", TF32_SHAPES)
def test_tf32x3_order_matches_reference(b, h, kh, s, d, lens, layout):
    """The float32 kernel's arithmetic (3xTF32 products, each step rounded
    toward zero as the tensor cores do, into per-block temporaries; splits
    of the kernel's plan on a 132-SM card at two CTAs per SM, its ring
    stages and four warp slices) against the plain version and the
    reference's oracle and Pallas kernel (interpret mode, bs=64), at the
    float32 tolerance (5e-6), on k, v as [B, Kh, S, D] and as the model
    cache's [B, S, Kh, D] seen through a transpose."""
    q, k, v, _ = _inputs(b, h, kh, s, d, seed=7)
    kv_len = np.array(lens, np.int32)
    tq = torch.from_numpy(q)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if layout == "cache":
        tk, tv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (tk, tv))
    _, chunk = kernel.wave_plan(s, b * kh, 132, 2, STAGE)
    got = ref.decode_attention_tf32x3_order(
        tq, tk, tv, torch.from_numpy(kv_len), chunk=chunk, tile=STAGE)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    plain = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(kv_len))
    jargs = tuple(map(jnp.asarray, (q, k, v, kv_len)))
    want = np.asarray(jax_ref(*jargs))
    kern = np.asarray(jax_decode(*jargs, bs=64))
    got = got.numpy()
    assert float(np.max(np.abs(got - plain.numpy()))) < TOL
    assert float(np.max(np.abs(got - want))) < TOL
    assert float(np.max(np.abs(got - kern))) < TOL


def test_tf32x3_order_needs_three_passes():
    """One TF32 pass (a_hi b_hi alone, 10 mantissa bits an operand) leaves
    the float32 tolerance at qwen3-14b's head shape (G = 5, D = 128) by far;
    the three passes are inside it."""
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 10, 2, 256, 128, seed=8))
    kv_len = torch.tensor([256])
    want = ref.decode_attention_ref(q.double(), k.double(), v.double(),
                                    kv_len)
    errs = {p: float((ref.decode_attention_tf32x3_order(
        q, k, v, kv_len, chunk=128, tile=32, passes=p).double()
        - want).abs().max()) for p in (1, 3)}
    assert errs[3] < TOL < 10 * TOL < errs[1], errs
    with pytest.raises(ValueError, match="passes"):
        ref.decode_attention_tf32x3_order(q, k, v, kv_len, passes=2)


def test_tf32x3_order_zero_length_gives_nan():
    """kv_len = 0: NaN in exactly those rows, as the kernel and the oracle
    give; the other rows within 5e-6 of the plain version."""
    q, k, v, _ = map(torch.from_numpy, _inputs(3, 4, 2, 100, 16))
    kv_len = torch.tensor([0, 37, 0])
    out = ref.decode_attention_tf32x3_order(q, k, v, kv_len, chunk=64,
                                            tile=64)
    want = ref.decode_attention_ref(q, k, v, kv_len)
    dead = (kv_len == 0)[:, None, None].expand_as(out)
    assert torch.isnan(out[dead]).all()
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert (out[~dead] - want[~dead]).abs().max() < TOL
