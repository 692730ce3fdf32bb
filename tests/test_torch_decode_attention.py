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
{64, 128}, and its split plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.models.layers import chunked_attention, dense_attention

TOL = 5e-6
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


def test_split_plan_covers_the_cache():
    """The split count fills the card and every key lies in one split."""
    for s in (1, 31, 32, 1000, 2048, 8192):
        for ctas in (1, 12, 64, 4096):
            splits, chunk = kernel.split_plan(s, ctas, 132)
            assert chunk % kernel.TILE == 0
            assert (splits - 1) * chunk < s <= splits * chunk
            assert splits == 1 or ctas * splits <= 2 * kernel.CTAS_PER_SM * 132


def test_cuda_backend_refuses_cpu_tensors_and_bad_shapes():
    q, k, v, kv_len = map(torch.from_numpy, _inputs(1, 4, 2, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, v, kv_len, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_cuda(q, k, v, kv_len)
    with pytest.raises(ValueError, match="head_dim"):
        kernel.decode_attention_cuda(q[..., :8].contiguous(),
                                     k[..., :8], v[..., :8], kv_len)
    q17, k1, v1, _ = map(torch.from_numpy, _inputs(1, 17, 1, 32, 16))
    with pytest.raises(ValueError, match="at most 16"):
        kernel.decode_attention_cuda(q17, k1, v1, kv_len)


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
    _, chunk = kernel.bf16_plan(s, b * kh, 132, 1)
    got = ref.decode_attention_kernel_order(tq, tk, tv,
                                            torch.from_numpy(kv_len),
                                            chunk=chunk,
                                            tile=kernel.BF16_TILE)
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


@pytest.mark.parametrize("per_sm", [1, 2, 8, 10])
def test_bf16_plan_fills_one_wave(per_sm):
    """The bf16 split plan, for a card that holds ``per_sm`` CTAs per SM
    (the occupancy calculator's count, read on the card): 64-key chunks
    that cover the cache, and no more CTAs than the card holds at once
    (unless one split is already more)."""
    for s in (1, 63, 64, 1000, 2048, 8192):
        for ctas in (1, 12, 64, 4096):
            splits, chunk = kernel.bf16_plan(s, ctas, 132, per_sm)
            assert chunk % kernel.BF16_TILE == 0
            assert (splits - 1) * chunk < s <= splits * chunk
            assert splits == 1 or ctas * splits <= per_sm * 132
    # qwen3-14b's full cache at two CTAs per SM: 64 CTAs a split, 4 splits
    # = one wave of 264 slots
    assert kernel.bf16_plan(8192, 64, 132, 2) == (4, 2048)
