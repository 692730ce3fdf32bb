"""The port's MoE MLP and the MoE models against the reference's, on
reduced dbrx-132b (4 experts top-2), arctic-480b (with its parallel dense
residual) and jamba-1.5-large-398b (MoE every other layer), with the
reference's weights carried across by ``convert``:

- ``moe_mlp``: the routing (top-k expert indices) equal exactly, ``y`` and
  the aux loss within 1e-5, in one group and in four groups of 16 tokens
  (capacity factor 1.25), and with skewed tokens, so that a busy expert
  drops some;
- group invariance at capacity factor 8 (the reference's
  ``tests/test_models.py::test_moe_group_invariance_with_high_capacity``);
- ``forward_train`` of the MoE models: logits within 1e-4, aux within
  1e-5;
- MoE decode at capacity factor 16 (routing then does not depend on the
  batch): every step within 1e-4 of the reference's decode loop and within
  the reference's 5e-3 of the prefill (``tests/test_models.py``);
- ``launch.serve.serve`` on the three MoE archs.
"""
import dataclasses

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
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                init_cache, moe)

MOE_ARCHS = ("dbrx-132b", "arctic-480b", "jamba-1.5-large-398b")
TOL = 1e-5
LOGITS_TOL = 1e-4
CPU = "cpu"


def _cfgs(arch, capacity=None):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if capacity is not None:
        jcfg, cfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=capacity))
            for c in (jcfg, cfg))
    return jcfg, cfg


def _moe_weights(arch, capacity=None, seed=0):
    jcfg, cfg = _cfgs(arch, capacity)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    p = convert.weights_from_reference(jax.tree.map(np.asarray, jp),
                                       device=CPU)
    return jcfg, cfg, jp, p


def _x(b, s, d, seed=0, scale=1.0, skew=0.0):
    """N(0, scale^2) tokens; with ``skew`` every token also carries one
    shared N(0, skew^2) vector, so most pick the same experts and a busy
    expert overflows its capacity."""
    rs = np.random.RandomState(seed)
    x = scale * rs.standard_normal((b, s, d))
    return (x + skew * rs.standard_normal((1, 1, d))).astype(np.float32)


def _ref_topi(jp, x, cfg, group_size):
    """The reference's routing (moe.py:53-56): softmax of the router
    logits per group, top-k indices."""
    b, s, d = x.shape
    g = min(group_size, b * s)
    xg = jnp.asarray(x).reshape(b * s // g, g, d)
    logits = jnp.einsum("gsd,de->gse", xg, jp["router"]).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    cfg.moe.top_k)[1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("group_size,skew", [(1024, 0.0), (16, 0.0),
                                             (16, 3.0)])
def test_moe_mlp_matches_reference(arch, group_size, skew):
    jcfg, cfg, jp, p = _moe_weights(arch)
    assert hasattr(p, "dense") == cfg.moe.dense_residual
    x = _x(2, 32, cfg.d_model, skew=skew)
    want_y, want_aux = jmoe.moe_mlp(jp, jnp.asarray(x), cfg=jcfg,
                                    group_size=group_size)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        r = moe.route(p, xt, cfg=cfg, group_size=group_size)
        y, aux = moe.moe_mlp(p, xt, cfg=cfg, group_size=group_size)
    flips = int((r["topi"].numpy() != _ref_topi(jp, x, jcfg,
                                                group_size)).sum())
    assert flips == 0, f"{flips} routing slots differ from the reference's"
    assert r["disp"].sum(dim=(2, 3)).max() <= cfg.moe.top_k
    assert y.shape == x.shape and aux.dtype == torch.float32
    assert float(np.max(np.abs(y.numpy() - np.asarray(want_y)))) < TOL
    assert abs(float(aux) - float(want_aux)) < TOL


def test_moe_capacity_drops_tokens():
    """With the default capacity factor and skewed tokens some slots of a
    group of 16 are over capacity and dropped (``disp`` has fewer than
    top_k ones for them); the test above holds the skewed case against the
    reference."""
    _, cfg, _, p = _moe_weights("dbrx-132b")
    assert moe._capacity(16, 4, 2, 1.25) == 12
    with torch.no_grad():
        r = moe.route(p, torch.from_numpy(_x(2, 32, cfg.d_model, skew=3.0)),
                      cfg=cfg, group_size=16)
    per_token = r["disp"].sum(dim=(2, 3))
    assert per_token.max() == cfg.moe.top_k
    assert per_token.min() < cfg.moe.top_k
    assert r["disp"].sum(dim=1).max() <= 1          # one token a slot


def test_moe_group_invariance_with_high_capacity():
    _, cfg, _, p = _moe_weights("dbrx-132b", capacity=8.0)
    x = torch.from_numpy(_x(2, 16, cfg.d_model, scale=0.5))
    with torch.no_grad():
        y_all, _ = moe.moe_mlp(p, x, cfg=cfg)
        y_tok = torch.cat([moe.moe_mlp(p, x[:, t:t + 1], cfg=cfg)[0]
                           for t in range(16)], dim=1)
    assert float((y_all - y_tok).abs().max()) < 1e-5


def _model(arch, capacity=None, seed=0):
    jcfg, cfg = _cfgs(arch, capacity)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return jcfg, cfg, jparams, params


_JCALL = JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                 remat=False)
_CALL = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                   remat=False)


@pytest.mark.parametrize("arch", MOE_ARCHS[:2])
def test_moe_forward_train_matches_reference(arch):
    """dbrx and arctic; jamba's is tests/test_torch_mamba.py's."""
    jcfg, cfg, jparams, params = _model(arch)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (2, 32))
    want, want_aux = jax_forward(jparams, jcfg, _JCALL,
                                 {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = forward_train(params, cfg, _CALL,
                                 {"tokens": torch.from_numpy(tokens)})
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < LOGITS_TOL
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) < TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_reference_and_prefill(arch):
    b, s = 2, 8
    jcfg, cfg, jparams, params = _model(arch, capacity=16.0, seed=1)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (b, s))
    jcache = jax_init_cache(jcfg, b, s, jnp.float32)
    cache = init_cache(cfg, b, s, torch.float32, device=CPU)
    with torch.no_grad():
        prefill, _ = forward_train(params, cfg, _CALL,
                                   {"tokens": torch.from_numpy(tokens)})
    errs, self_errs = [], []
    for t in range(s):
        jl, jcache = jax_decode(jparams, jcfg, _JCALL,
                                {"tokens": jnp.asarray(tokens[:, t])},
                                jcache, jnp.int32(t))
        lg, cache = forward_decode(params, cfg, _CALL,
                                   {"tokens": torch.from_numpy(tokens[:, t])},
                                   cache, t)
        errs.append(float(np.max(np.abs(lg.numpy() - np.asarray(jl)))))
        self_errs.append(float((lg - prefill[:, t]).abs().max()))
    assert max(errs) < LOGITS_TOL, errs
    assert max(self_errs) < 5e-3, self_errs          # tests/test_models.py


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_runs_moe_archs(arch):
    from repro_torch.launch.serve import serve
    out = serve(arch, reduced=True, batch=2, prompt_len=4, gen=6,
                verbose=False, device=CPU)
    toks = out["tokens"]
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < get_config(arch).reduced().vocab)).all()
