"""The port's flash-decoding (plain PyTorch path, as the CPU runs it)
against the reference's Pallas decode kernel (interpret mode on the CPU,
bs=64) and its ``decode_attention_ref``, at the shapes and tolerance (5e-6,
float32) of tests/test_kernels.py — GQA, MHA, MQA, ragged ``kv_len`` —
plus the dense-path twin of that file's model check: the port's cache
attention (dense and chunked, with ``kv_len``) against the port's decode
attention on the model cache's [B, S, Kh, D] layout seen as a transposed
view, and the kernel wrapper's checks that run without a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import kernel, ops
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
