"""The port's dense decoder LM against the reference's, for reduced
smollm-135m (GQA, tied head), reduced qwen3-14b (qk-norm, untied head) and
reduced musicgen-medium (the audio family: frame embeddings [B, S, D] in
place of tokens, no embedding table), the last also as MHA (its published
n_kv_heads = n_heads, a GQA group of 1; ``reduced()`` leaves it GQA), with
the reference's weights carried across by ``convert``:

- ``forward_train`` logits under "dense", "chunked" (both the flash_chunked
  and the padded chunked path) and "pallas" + use_pallas_norm, against the
  reference's under the same CallConfig (its Pallas kernels in interpret
  mode): max abs difference below 1e-4;
- a ``forward_decode`` loop: the logits of every step and the final cache
  against the reference's loop, below 1e-4;
- param accounting and ``init_params`` shapes, for every arch (dense,
  MoE, the Mamba hybrid, xLSTM and the vision model's cross-attention).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.configs import param_count as jax_param_count
from repro.models import CallConfig as JaxCall
from repro.models import forward_decode as jax_decode
from repro.models import forward_train as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import get_config, param_count
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                init_cache, init_params, param_count_actual)

ARCHS = ("smollm-135m", "qwen3-14b", "musicgen-medium",
         "musicgen-medium-mha")
# test-only variants: (the arch, the fields replaced in its reduced config)
VARIANTS = {"musicgen-medium-mha": ("musicgen-medium",
                                    {"n_heads": 4, "n_kv_heads": 4})}
TOL = 1e-4
CPU = "cpu"
# (attention_impl, attn_chunk, use_pallas_norm): chunk 16 divides S=32, so
# "chunked" takes flash_chunked; 512 does not, so it takes the padded
# chunked_attention
IMPLS = [("dense", 512, False), ("chunked", 16, False),
         ("chunked", 512, False), ("pallas", 16, True)]
# the archs the port runs: every one
RUN_ARCHS = list(list_archs())


def _calls(impl, chunk, pallas_norm):
    kw = dict(attention_impl=impl, attn_chunk=chunk,
              use_pallas_norm=pallas_norm, remat=False)
    return (JaxCall(compute_dtype=jnp.float32, **kw),
            CallConfig(compute_dtype=torch.float32, **kw))


def _reduced(arch):
    """(the reference's, the port's) reduced config of ``arch`` or of a
    VARIANTS entry."""
    base, fields = VARIANTS.get(arch, (arch, {}))
    return tuple(dataclasses.replace(get(base).reduced(), **fields)
                 for get in (jax_get_config, get_config))


def _inputs(cfg, b, s, seed):
    """tokens [b, s] or, for a config without an embedding table,
    frame_emb [b, s, d_model] float32 ~ 0.1 N(0, 1) (the reference's
    tests/test_models.py scale)."""
    rs = np.random.RandomState(seed)
    if cfg.embed_inputs:
        return rs.randint(0, cfg.vocab, (b, s))
    return (0.1 * rs.standard_normal((b, s, cfg.d_model))).astype(np.float32)


def _key(cfg):
    return "tokens" if cfg.embed_inputs else "frame_emb"


def _jbatch(cfg, x):
    return {_key(cfg): jnp.asarray(x)}


def _batch(cfg, x):
    return {_key(cfg): torch.from_numpy(x)}


def _step(x, t):
    """Decode step t's input: tokens [B] or frame_emb [B, 1, D]."""
    return x[:, t] if x.ndim == 2 else x[:, t:t + 1]


def _setup(arch, b, s, seed=0):
    jcfg, cfg = _reduced(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return jcfg, cfg, jparams, params, _inputs(cfg, b, s, seed)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,chunk,pallas_norm", IMPLS)
def test_forward_train_matches_reference(arch, impl, chunk, pallas_norm):
    jcfg, cfg, jparams, params, tokens = _setup(arch, 2, 32)
    jcall, call = _calls(impl, chunk, pallas_norm)
    want, _ = jax_forward(jparams, jcfg, jcall, _jbatch(cfg, tokens))
    with torch.no_grad():
        got, aux = forward_train(params, cfg, call, _batch(cfg, tokens))
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    assert err < TOL, err


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,chunk,pallas_norm",
                         [IMPLS[0], IMPLS[3]])
def test_decode_loop_matches_reference(arch, impl, chunk, pallas_norm):
    b, s = 2, 8
    jcfg, cfg, jparams, params, tokens = _setup(arch, b, s, seed=1)
    jcall, call = _calls(impl, chunk, pallas_norm)
    jcache = jax_init_cache(jcfg, b, s, jnp.float32)
    cache = init_cache(cfg, b, s, torch.float32, device=CPU)
    with torch.no_grad():
        prefill, _ = forward_train(params, cfg, call, _batch(cfg, tokens))
    errs, self_errs = [], []
    for t in range(s):
        step = _step(tokens, t)
        jl, jcache = jax_decode(jparams, jcfg, jcall, _jbatch(cfg, step),
                                jcache, jnp.int32(t))
        lg, cache = forward_decode(params, cfg, call, _batch(cfg, step),
                                   cache, t)
        assert lg.shape == (b, cfg.vocab)
        errs.append(float(np.max(np.abs(lg.numpy() - np.asarray(jl)))))
        self_errs.append(float((lg - prefill[:, t]).abs().max()))
    assert max(errs) < TOL, errs
    assert max(self_errs) < 5e-3, self_errs          # tests/test_models.py
    ours = convert.cache_to_numpy(cache, cfg)
    for i, (mine, ref) in enumerate(zip(ours, jcache)):
        for key in ("k", "v"):
            assert mine[key].shape == ref[key].shape
            err = float(np.max(np.abs(mine[key] - np.asarray(ref[key]))))
            assert err < TOL, (i, key, err)
    # and back: the reference's cache read into the port is the port's
    again = convert.cache_from_reference(
        jax.tree.map(np.asarray, jcache), cfg, device=CPU)
    for c_ref, c_port in zip(again, cache):
        assert torch.allclose(c_ref["k"], c_port["k"], atol=TOL)


def test_decode_position_outside_cache_raises():
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, 0, device=CPU)
    cache = init_cache(cfg, 1, 4, torch.float32, device=CPU)
    call = CallConfig(compute_dtype=torch.float32, remat=False)
    with pytest.raises(ValueError, match="position 4"):
        forward_decode(params, cfg, call,
                       {"tokens": torch.zeros(1, dtype=torch.long)},
                       cache, 4)


@pytest.mark.parametrize("arch", list_archs())
def test_config_copies_match_reference(arch):
    mine, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for c_mine, c_ref in ((mine, ref), (mine.reduced(), ref.reduced())):
        assert param_count(c_mine) == jax_param_count(c_ref)
        assert c_mine.layer_kinds() == c_ref.layer_kinds()


@pytest.mark.parametrize("arch", list_archs())
def test_init_params_shapes_and_count(arch):
    """Every arch: its init_params has param_count(cfg) parameters and the
    reference's tree of names and shapes (the reference's eval_shape tree
    loads into it strictly), and its init_cache the reference's cache
    tree of names and shapes."""
    assert arch in RUN_ARCHS
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device=CPU)
    assert param_count_actual(params) == param_count(cfg)
    shapes = jax.eval_shape(partial(jax_init_params, jax_get_config(arch)
                                    .reduced()), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    loaded = convert.model_params_from_reference(zeros, cfg, device=CPU)
    assert ({n: t.shape for n, t in loaded.state_dict().items()}
            == {n: t.shape for n, t in params.state_dict().items()})
    cache = convert.cache_to_numpy(init_cache(cfg, 2, 4, torch.float32,
                                              device=CPU), cfg)
    jcache = jax.eval_shape(partial(jax_init_cache, jax_get_config(arch)
                                    .reduced(), 2, 4, jnp.float32))
    assert [{k: v.shape for k, v in c.items()} for c in cache] == \
        [{k: v.shape for k, v in c.items()} for c in jcache]
    # the scales of the draws: embed ~ N(0, 0.02^2), wq (attention or
    # mLSTM) ~ N(0, 1/d)
    if cfg.embed_inputs:
        assert abs(float(params.embed.detach().std()) - 0.02) < 0.002
    first = next(i for i, k in enumerate(cfg.layer_kinds())
                 if k in ("attn", "mlstm"))
    wq = params.layers[first].mixer.wq.detach()
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_full_width_param_count():
    """smollm-135m at full width: the count the chip run builds."""
    cfg = get_config("smollm-135m")
    assert param_count(cfg) == 134_515_008


MESH_KNOBS = ({"batch_axes": ("data",)}, {"seq_axis": "model"},
              {"moe_ep_axis": "model"},
              {"batch_axes": ("pod", "data"), "seq_axis": "model",
               "moe_ep_axis": "model"})


def test_mesh_knobs_raise():
    """Every CallConfig the reference accepts is accepted, the mesh knobs
    included (they shard DTensor activations, distributed/sharding.py);
    what raises is an attention_impl the port does not have."""
    for kw in MESH_KNOBS:
        assert CallConfig(**kw) == dataclasses.replace(CallConfig(), **kw)
    with pytest.raises(ValueError, match="attention_impl"):
        CallConfig(attention_impl="flash")


@pytest.mark.parametrize("arch", ["qwen3-14b", "dbrx-132b"])
def test_mesh_knobs_on_plain_tensors(arch):
    """On plain tensors the knobs change nothing (the reference's sharding
    constraint is a no-op without a mesh): logits bitwise equal to the
    knob-free call's, and equal to the reference's within TOL."""
    jcfg, cfg, jparams, params, tokens = _setup(arch, 2, 32)
    base = dict(compute_dtype=torch.float32, attention_impl="dense",
                remat=False, moe_group_size=16)
    with torch.no_grad():
        want, _ = forward_train(params, cfg, CallConfig(**base),
                                {"tokens": torch.from_numpy(tokens)})
        for kw in MESH_KNOBS:
            got, _ = forward_train(params, cfg, CallConfig(**base, **kw),
                                   {"tokens": torch.from_numpy(tokens)})
            assert torch.equal(got, want), kw
    ref, _ = jax_forward(jparams, jcfg, JaxCall(
        compute_dtype=jnp.float32, attention_impl="dense", remat=False,
        moe_group_size=16, **MESH_KNOBS[-1]), {"tokens": jnp.asarray(tokens)})
    assert float(np.max(np.abs(want.numpy() - np.asarray(ref)))) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_expand_kv_matches_reference(arch):
    """KV heads repeated up front (``gqa_expand_kv``), under "chunked":
    the same logits as the reference with the same flag."""
    jcfg, cfg, jparams, params, tokens = _setup(arch, 2, 32)
    kw = dict(attention_impl="chunked", attn_chunk=16, remat=False,
              gqa_expand_kv=True)
    want, _ = jax_forward(jparams, jcfg,
                          JaxCall(compute_dtype=jnp.float32, **kw),
                          _jbatch(cfg, tokens))
    with torch.no_grad():
        got, _ = forward_train(params, cfg,
                               CallConfig(compute_dtype=torch.float32, **kw),
                               _batch(cfg, tokens))
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,chunk,pallas_norm",
                         [IMPLS[0], IMPLS[1], IMPLS[3]])
def test_bf16_forward_matches_reference(arch, impl, chunk, pallas_norm):
    """Weights and compute in bfloat16, as the reference runs them (its
    layer scan needs one dtype). Every product's output rounds to bf16 in
    both packages, at places an ulp apart, so the bound is 2^-5 of the
    largest logit (about four bf16 ulps there; measured up to two)."""
    jcfg, cfg = _reduced(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    assert params.final_norm.dtype == torch.bfloat16
    tokens = _inputs(cfg, 2, 32, 0)
    kw = dict(attention_impl=impl, attn_chunk=chunk,
              use_pallas_norm=pallas_norm, remat=False)
    want, _ = jax_forward(jparams, jcfg,
                          JaxCall(compute_dtype=jnp.bfloat16, **kw),
                          _jbatch(cfg, tokens))
    with torch.no_grad():
        got, _ = forward_train(params, cfg,
                               CallConfig(compute_dtype=torch.bfloat16, **kw),
                               _batch(cfg, tokens))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err < 2 ** -5 * float(np.abs(want).max()), err


def test_remat_recomputes_the_same_forward():
    """With autograd on, remat runs each layer under
    torch.utils.checkpoint: the same logits and the same gradients."""
    cfg = get_config("smollm-135m").reduced()
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (2, 16)))
    out = []
    for remat in (False, True):
        params = init_params(cfg, 0, device=CPU)
        call = CallConfig(compute_dtype=torch.float32, remat=remat)
        logits, _ = forward_train(params, cfg, call, {"tokens": tokens})
        logits.square().mean().backward()
        out.append((logits.detach(), params.layers[0].mixer.wq.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.allclose(out[0][1], out[1][1], atol=1e-7)
