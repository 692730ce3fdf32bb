"""Gradients of the port against the reference's, with the reference's
inputs and weights carried across:

- ``flash_chunked`` (the custom backward, ``_FlashChunked``) against
  ``jax.grad`` of the reference's ``flash_chunked`` within 1e-5, and
  against plain autograd through ``dense_attention`` within 1e-4 of the
  gradient's scale (relative);
- the selective scan's custom backward (``_SelectiveScan``, no h0, S a
  multiple of the chunk) against ``jax.grad`` of the reference's
  ``mamba_ssm`` within 1e-5 relative and against plain autograd through
  the padded chunked scan within 1e-4 relative;
- ``loss_fn``'s value and its full gradient tree (``convert.
  model_params_to_reference`` of the grads) against
  ``jax.value_and_grad`` within 1e-4 relative, for dense, MoE (arctic's
  dense residual), hybrid (jamba: Mamba, attention, MoE) and audio
  (musicgen: frame embeddings in place of tokens, no embedding table)
  configs, and with a ``loss_mask`` and the chunked attention route;
- the hand-written kernels' routes (``attention_impl="pallas"``,
  ``use_pallas_norm``, ``mamba_forward(use_kernel=True)``) raising
  NotImplementedError under autograd, as the reference's ``jax.grad``
  through a ``pallas_call`` raises, and running under ``no_grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import CallConfig as JaxCall
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jax_loss_fn
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (CallConfig, forward_train, init_params,
                                layers, loss_fn, ssm)

CPU = "cpu"


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _randn(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("h,kh,chunk", [(4, 2, 8), (4, 4, 16), (6, 2, 32)])
def test_flash_chunked_grad_matches_reference(h, kh, chunk):
    rs = np.random.RandomState(0)
    b, s, d = 2, 32, 16
    q, k, v = _randn(rs, b, s, h, d), _randn(rs, b, s, kh, d), \
        _randn(rs, b, s, kh, d)
    do = _randn(rs, b, s, h, d)

    def jloss(q, k, v):
        return jnp.sum(jlayers.flash_chunked(q, k, v, True, chunk) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_chunked(qt, kt, vt, True, chunk)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(),
                              (qt, kt, vt))
    plain = torch.autograd.grad(
        (layers.dense_attention(qt, kt, vt, causal=True)
         * torch.from_numpy(do)).sum(), (qt, kt, vt))
    for name, g, w, p in zip("qkv", got, want, plain):
        assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) < 1e-5, name
        assert _rel(g.numpy(), p.numpy()) < 1e-4, name


def _scan_inputs(rs, b, s, di, n):
    x = _randn(rs, b, s, di)
    dt = (0.05 + 0.1 * rs.random_sample((b, s, di))).astype(np.float32)
    B, C = _randn(rs, b, s, n), _randn(rs, b, s, n)
    A = -np.exp(_randn(rs, di, n) * 0.5).astype(np.float32)
    D = _randn(rs, di)
    return x, dt, B, C, A, D


@pytest.mark.parametrize("s,chunk", [(32, 16), (64, 16), (32, 32)])
def test_selective_scan_grad_matches_reference(s, chunk):
    rs = np.random.RandomState(1)
    ins = _scan_inputs(rs, 2, s, 12, 8)
    dy = _randn(rs, 2, s, 12)

    def jloss(*a):
        return jnp.sum(jssm.mamba_ssm(*a, chunk) * dy)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*ins)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    dyt = torch.from_numpy(dy)
    got = torch.autograd.grad((ssm.mamba_ssm(*ts, chunk) * dyt).sum(), ts)
    # plain autograd through the padded chunked scan (an explicit zero h0
    # takes it)
    h0 = torch.zeros((2, 12, 8))
    plain = torch.autograd.grad(
        (ssm.mamba_ssm(*ts, chunk, h0=h0) * dyt).sum(), ts)
    for name, g, w, p in zip(("x", "dt", "B", "C", "A", "D"), got, want,
                             plain):
        assert g.shape == tuple(np.shape(w)), name
        assert _rel(g.numpy(), w) < 1e-5, name
        assert _rel(g.numpy(), p.numpy()) < 1e-4, name


def _setup(arch, seed=0):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return jcfg, cfg, jparams, params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("arch,impl,masked", [
    ("smollm-135m", "dense", False),
    ("smollm-135m", "dense", True),
    ("qwen3-14b", "chunked", False),
    ("arctic-480b", "dense", False),
    ("jamba-1.5-large-398b", "dense", False),
    ("musicgen-medium", "dense", False),
    ("musicgen-medium", "chunked", True),
])
def test_loss_fn_grads_match_reference(arch, impl, masked):
    jcfg, cfg, jparams, params = _setup(arch)
    rs = np.random.RandomState(2)
    b, s = 2, 32
    if cfg.embed_inputs:
        key, x = "tokens", rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    else:
        key, x = "frame_emb", (0.1 * rs.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    labels = rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    jbatch = {key: jnp.asarray(x), "labels": jnp.asarray(labels)}
    batch = {key: torch.from_numpy(x), "labels": torch.from_numpy(labels)}
    if masked:
        mask = (rs.random_sample((b, s)) < 0.7).astype(np.float32)
        jbatch["loss_mask"] = jnp.asarray(mask)
        batch["loss_mask"] = torch.from_numpy(mask)
    kw = dict(attention_impl=impl, attn_chunk=16, remat=False)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, JaxCall(compute_dtype=jnp.float32,
                                               **kw), jbatch),
        has_aux=True)(jparams)
    call = CallConfig(compute_dtype=torch.float32, **kw)
    loss, parts = loss_fn(params, cfg, call, batch)
    loss.backward()
    parts = {k: v.detach() for k, v in parts.items()}
    assert _rel(loss.item(), jloss) < 1e-5
    for key in ("nll", "aux", "zloss"):
        assert abs(parts[key].item() - float(jparts[key])) \
            <= 1e-5 * max(abs(float(jparts[key])), 1.0), key
    grads = convert.model_params_to_reference(
        {n: p.grad for n, p in params.named_parameters()}, cfg)
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    got = dict(_leaves(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.shape == want[name].shape, name
        assert _rel(g, want[name]) < 1e-4, (name, _rel(g, want[name]))


def test_loss_fn_remat_matches_plain():
    """``call.remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``), the MoE aux loss included: the same loss
    and gradients as without."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = init_params(cfg, 0, device=CPU)
    rs = np.random.RandomState(3)
    batch = {"tokens": torch.from_numpy(rs.randint(0, cfg.vocab, (2, 16))),
             "labels": torch.from_numpy(rs.randint(0, cfg.vocab, (2, 16)))}
    out = []
    for remat in (False, True):
        params.zero_grad(set_to_none=True)
        call = CallConfig(compute_dtype=torch.float32, remat=remat)
        loss, parts = loss_fn(params, cfg, call, batch)
        loss.backward()
        out.append((loss.item(), parts["aux"].item(),
                    [p.grad.clone() for p in params.parameters()]))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1] > 0
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)


_ROUTES = {
    "pallas_attention": dict(attention_impl="pallas"),
    "pallas_norm": dict(use_pallas_norm=True),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_kernel_routes_refuse_autograd(route):
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, 0, device=CPU)
    call = CallConfig(compute_dtype=torch.float32, remat=False,
                      **_ROUTES[route])
    tokens = torch.zeros((1, 16), dtype=torch.long)
    batch = {"tokens": tokens, "labels": tokens}
    with pytest.raises(NotImplementedError, match="no backward"):
        loss_fn(params, cfg, call, batch)
    with torch.no_grad():                      # inference runs the route
        logits, _ = forward_train(params, cfg, call, batch)
    assert torch.isfinite(logits).all()


def test_scan_kernel_route_refuses_autograd():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = init_params(cfg, 0, device=CPU)
    mixer = params.layers[0].mixer
    x = torch.from_numpy(_randn(np.random.RandomState(4), 1, 16,
                                cfg.d_model))
    with pytest.raises(NotImplementedError, match="no backward"):
        ssm.mamba_forward(mixer, x, cfg=cfg, use_kernel=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ssm.mamba_ssm(*(torch.from_numpy(a).requires_grad_() for a in
                        _scan_inputs(np.random.RandomState(5), 1, 16, 8, 4)),
                      16, use_kernel=True)
    with torch.no_grad():
        y = ssm.mamba_forward(mixer, x, cfg=cfg, use_kernel=True)
    assert torch.isfinite(y).all()
