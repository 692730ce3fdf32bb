"""The port's cross-attention and the llama-3.2-vision-11b model against
the reference's, reduced config (d 64, 4/2 heads, D 16, five layers, the
fifth with cross-attention, 7 memory tokens), float32, the reference's
weights carried across by ``convert``; max abs difference below 1e-4:

- ``init_attention(cross=True)``: no bias and no qk-norm, whatever the
  config says;
- ``cross_attention`` alone under "dense", "chunked" and "pallas", with
  M = 7 and with M a multiple of ``attn_chunk`` and not;
- ``forward_train`` logits under each of ``test_torch_model.IMPLS`` (the
  reference's Pallas kernels in interpret mode), and a missing
  ``vision_mem`` raising;
- a ``forward_decode`` loop (the memory re-projected every step): every
  step's logits and the final cache against the reference's, and decode
  against prefill within 5e-3 (the reference's bound);
- ``loss_fn``'s loss (1e-5) and whole gradient tree (1e-4 of each leaf's
  scale) against ``jax.value_and_grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import CallConfig as JaxCall
from repro.models import forward_decode as jax_decode
from repro.models import forward_train as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jax_loss_fn
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                init_cache, layers, loss_fn)

ARCH = "llama-3.2-vision-11b"
TOL = 1e-4
CPU = "cpu"
# test_torch_model.IMPLS: (attention_impl, attn_chunk, use_pallas_norm)
IMPLS = [("dense", 512, False), ("chunked", 16, False),
         ("chunked", 512, False), ("pallas", 16, True)]


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def _calls(impl, chunk, pallas_norm=False):
    kw = dict(attention_impl=impl, attn_chunk=chunk,
              use_pallas_norm=pallas_norm, remat=False)
    return (JaxCall(compute_dtype=jnp.float32, **kw),
            CallConfig(compute_dtype=torch.float32, **kw))


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "qwen3-14b", ARCH])
def test_init_cross_attention_has_no_bias_or_norm(arch):
    """A config with qkv_bias (qwen1.5) or qk_norm (qwen3): the self layer
    has them, the cross layer neither, in both packages."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    for cross in (False, True):
        want = jlayers.init_attention(jcfg, jax.random.PRNGKey(0),
                                      cross=cross)
        got = layers.init_attention(cfg, gen, device=CPU, cross=cross)
        assert ({n: tuple(t.shape) for n, t in got.named_parameters()}
                == {n: np.shape(v) for n, v in want.items()}), cross
    assert set(dict(got.named_parameters())) == {"wq", "wk", "wv", "wo"}


@pytest.mark.parametrize("m,impl,chunk", [
    (7, "dense", 512), (7, "chunked", 512), (7, "pallas", 512),
    (7, "chunked", 4),            # M not a multiple of the chunk
    (16, "chunked", 8),           # M a multiple of it
    (13, "pallas", 8),
])
def test_cross_attention_matches_reference(m, impl, chunk):
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(np.asarray, jlayers.init_attention(
        jcfg, jax.random.PRNGKey(1), cross=True))
    p = convert.weights_from_reference(jp, device=CPU)
    rs = np.random.RandomState(m)
    x = rs.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    mem = rs.standard_normal((2, m, cfg.d_model)).astype(np.float32)
    jcall, call = _calls(impl, chunk)
    want = jlayers.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem),
                                   cfg=jcfg, call=jcall)
    with torch.no_grad():
        got = layers.cross_attention(p, torch.from_numpy(x),
                                     torch.from_numpy(mem), cfg=cfg,
                                     call=call)
    assert got.shape == (2, 12, cfg.d_model)
    assert _err(got.numpy(), want) < TOL


def _setup(seed=0, b=2, s=32):
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab, (b, s))
    mem = (0.1 * rs.standard_normal(
        (b, cfg.cross_attn.n_mem_tokens, cfg.d_model))).astype(np.float32)
    return jcfg, cfg, jparams, params, tokens, mem


def test_model_layers():
    _, cfg, _, params, _, _ = _setup()
    assert [lp.cross is not None for lp in params.layers] == \
        [False] * 4 + [True]
    assert [lp.kind for lp in params.layers] == ["attn"] * 5
    names = {n for n, _ in params.layers[4].named_parameters()}
    assert {"cross_norm", "cross.wq", "cross.wk", "cross.wv",
            "cross.wo"} <= names


@pytest.mark.parametrize("impl,chunk,pallas_norm", IMPLS)
def test_forward_train_matches_reference(impl, chunk, pallas_norm):
    jcfg, cfg, jparams, params, tokens, mem = _setup()
    jcall, call = _calls(impl, chunk, pallas_norm)
    want, _ = jax_forward(jparams, jcfg, jcall,
                          {"tokens": jnp.asarray(tokens),
                           "vision_mem": jnp.asarray(mem)})
    with torch.no_grad():
        got, aux = forward_train(params, cfg, call,
                                 {"tokens": torch.from_numpy(tokens),
                                  "vision_mem": torch.from_numpy(mem)})
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    assert _err(got.numpy(), want) < TOL


def test_missing_vision_mem_raises():
    _, cfg, _, params, tokens, _ = _setup()
    call = CallConfig(compute_dtype=torch.float32, remat=False)
    with pytest.raises(ValueError, match="vision_mem"):
        forward_train(params, cfg, call,
                      {"tokens": torch.from_numpy(tokens)})


def test_memory_reaches_the_logits():
    """Another memory gives other logits (the cross layer is not a
    no-op) and a zero cross layer gives the self layers' logits."""
    _, cfg, _, params, tokens, mem = _setup()
    call = CallConfig(compute_dtype=torch.float32, remat=False)
    batch = {"tokens": torch.from_numpy(tokens),
             "vision_mem": torch.from_numpy(mem)}
    with torch.no_grad():
        a, _ = forward_train(params, cfg, call, batch)
        b, _ = forward_train(params, cfg, call,
                             dict(batch, vision_mem=2 * batch["vision_mem"]))
        params.layers[4].cross.wo.zero_()
        c, _ = forward_train(params, cfg, call, batch)
        d, _ = forward_train(params, cfg, call,
                             dict(batch, vision_mem=2 * batch["vision_mem"]))
    assert float((a - b).abs().max()) > 1e-3
    assert torch.equal(c, d)


@pytest.mark.parametrize("impl,chunk,pallas_norm", [IMPLS[0], IMPLS[3]])
def test_decode_loop_matches_reference(impl, chunk, pallas_norm):
    b, s = 2, 8
    jcfg, cfg, jparams, params, tokens, mem = _setup(seed=1, b=b, s=s)
    jcall, call = _calls(impl, chunk, pallas_norm)
    jcache = jax_init_cache(jcfg, b, s, jnp.float32)
    cache = init_cache(cfg, b, s, torch.float32, device=CPU)
    assert len(cache) == cfg.n_layers and all(set(c) == {"k", "v"}
                                              for c in cache)
    vm = torch.from_numpy(mem)
    with torch.no_grad():
        prefill, _ = forward_train(params, cfg, call,
                                   {"tokens": torch.from_numpy(tokens),
                                    "vision_mem": vm})
    errs, self_errs = [], []
    for t in range(s):
        jl, jcache = jax_decode(jparams, jcfg, jcall,
                                {"tokens": jnp.asarray(tokens[:, t]),
                                 "vision_mem": jnp.asarray(mem)},
                                jcache, jnp.int32(t))
        lg, cache = forward_decode(params, cfg, call,
                                   {"tokens": torch.from_numpy(tokens[:, t]),
                                    "vision_mem": vm}, cache, t)
        errs.append(_err(lg.numpy(), jl))
        self_errs.append(float((lg - prefill[:, t]).abs().max()))
    assert max(errs) < TOL, errs
    assert max(self_errs) < 5e-3, self_errs
    for mine, ref in zip(convert.cache_to_numpy(cache, cfg), jcache):
        for key in ("k", "v"):
            assert _err(mine[key], ref[key]) < TOL, key


def test_loss_fn_grads_match_reference():
    jcfg, cfg, jparams, params, tokens, mem = _setup(seed=2)
    labels = np.random.RandomState(3).randint(0, cfg.vocab, tokens.shape)
    kw = dict(attention_impl="chunked", attn_chunk=16, remat=False)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, JaxCall(compute_dtype=jnp.float32,
                                               **kw),
                              {"tokens": jnp.asarray(tokens),
                               "labels": jnp.asarray(labels),
                               "vision_mem": jnp.asarray(mem)}),
        has_aux=True)(jparams)
    loss, _ = loss_fn(params, cfg, CallConfig(compute_dtype=torch.float32,
                                              **kw),
                      {"tokens": torch.from_numpy(tokens),
                       "labels": torch.from_numpy(labels),
                       "vision_mem": torch.from_numpy(mem)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = jax.tree_util.tree_flatten_with_path(
        convert.model_params_to_reference(
            {n: p.grad for n, p in params.named_parameters()}, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrads))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        assert _err(g, w) / max(float(np.abs(w).max()), 1e-30) < 1e-4, path


def test_bf16_forward_matches_reference():
    """bf16 weights and compute, the kernels' plain routes: within 2^-5 of
    the largest logit, as test_torch_model's bf16 test holds the dense
    models (every product rounds to bf16 in both packages)."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    rs = np.random.RandomState(4)
    tokens = rs.randint(0, cfg.vocab, (2, 32))
    mem = (0.1 * rs.standard_normal((2, 7, cfg.d_model))).astype(np.float32)
    kw = dict(attention_impl="pallas", attn_chunk=16, use_pallas_norm=True,
              remat=False)
    want, _ = jax_forward(jparams, jcfg,
                          JaxCall(compute_dtype=jnp.bfloat16, **kw),
                          {"tokens": jnp.asarray(tokens),
                           "vision_mem": jnp.asarray(mem)})
    call = CallConfig(compute_dtype=torch.bfloat16, **kw)
    with torch.no_grad():
        got, _ = forward_train(params, cfg, call,
                               {"tokens": torch.from_numpy(tokens),
                                "vision_mem": torch.from_numpy(mem)})
    want = np.asarray(want)
    assert _err(got.numpy(), want) < 2 ** -5 * float(np.abs(want).max())
