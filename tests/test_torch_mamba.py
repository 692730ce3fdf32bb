"""The port's Mamba mixer and the hybrid decoder without MoE against the
reference's, on reduced jamba-1.5-large-398b (d_model 64, Di 128, N 8,
chunk 16), with the reference's weights carried across by ``convert``:

- ``mamba_forward`` with ``use_kernel`` off (the chunked scan) and on (the
  ssm_scan path: the reference's Pallas kernel in interpret mode, the
  port's plain version on the CPU), for S a multiple of the chunk and a
  ragged S: max abs difference below 1e-4; and the kernel path in
  bfloat16, below 1e-2;
- ``mamba_ssm`` from a given state ``h0`` (the padded branch), and
  ``use_kernel=True`` refusing an ``h0`` the reference would drop;
- ``mamba_decode`` over 32 steps: outputs and final state below 1e-4;
- ``forward_train`` and a ``forward_decode`` loop of the hybrid config with
  ``moe=None`` (7 Mamba layers and one attention layer, SwiGLU MLPs):
  logits below 1e-4 of the reference's, decode within the reference's
  5e-3 of the prefill (tests/test_models.py), caches both ways;
- ``jamba.reduced()`` itself, MoE every other layer: ``forward_train``
  logits and aux against the reference's.
"""
import dataclasses
from functools import partial

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
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, param_count
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                init_cache, init_params, param_count_actual,
                                ssm)

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4
CPU = "cpu"


def _mixer(seed=0):
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(seed))
    p = convert.weights_from_reference(jax.tree.map(np.asarray, jp),
                                       device=CPU)
    return jcfg, cfg, jp, p


def _x(b, s, d, seed=0):
    return np.random.RandomState(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("s", [32, 21])        # a multiple of the chunk, not
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_forward_matches_reference(s, use_kernel):
    jcfg, cfg, jp, p = _mixer()
    x = _x(2, s, cfg.d_model)
    want = jssm.mamba_forward(jp, jnp.asarray(x), cfg=jcfg,
                              use_kernel=use_kernel)
    before = ssm_kernel.launch_count
    with torch.no_grad():
        got = ssm.mamba_forward(p, torch.from_numpy(x), cfg=cfg,
                                use_kernel=use_kernel)
    assert ssm_kernel.launch_count == before         # the CPU: plain path
    assert got.shape == (2, s, cfg.d_model) and got.dtype == torch.float32
    assert _err(got.numpy(), want) < TOL


@pytest.mark.parametrize("s", [32, 21])
def test_mamba_forward_bf16_kernel_path_matches_reference(s):
    """bfloat16 weights and input through ``use_kernel=True``: the scan
    returns bf16 and adds D * x in float32 before its cast, as the
    reference's Pallas kernel does, so the output is bf16 and within 1e-2
    (one bf16 ulp is 3.9e-3 below 1, where these outputs lie)."""
    jcfg, cfg, jp, p = _mixer()
    x = _x(2, s, cfg.d_model)
    want = jssm.mamba_forward(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
        jnp.asarray(x).astype(jnp.bfloat16), cfg=jcfg, use_kernel=True)
    with torch.no_grad():
        got = ssm.mamba_forward(p.to(torch.bfloat16),
                                torch.from_numpy(x).to(torch.bfloat16),
                                cfg=cfg, use_kernel=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _err(got.float().numpy(), want.astype(jnp.float32)) < 1e-2


def test_mamba_ssm_from_a_state_matches_reference():
    """The padded branch with a nonzero h0 (S = 21, chunk 16)."""
    rng = np.random.RandomState(4)
    b, s, di, n = 2, 21, 12, 4
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, di)) - 1, 0).astype(
        np.float32)
    B, C = (rng.standard_normal((b, s, n)).astype(np.float32)
            for _ in range(2))
    A = -np.exp(rng.standard_normal((di, n)) * 0.3).astype(np.float32)
    D = rng.standard_normal((di,)).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    args = (x, dt, B, C, A, D)
    want = jssm.mamba_ssm(*map(jnp.asarray, args), 16, h0=jnp.asarray(h0))
    got = ssm.mamba_ssm(*map(torch.from_numpy, args), 16,
                        h0=torch.from_numpy(h0))
    assert _err(got.numpy(), want) < TOL
    with pytest.raises(ValueError, match="h0"):
        ssm.mamba_ssm(*map(torch.from_numpy, args), 16,
                      h0=torch.from_numpy(h0), use_kernel=True)


def test_mamba_decode_matches_reference():
    jcfg, cfg, jp, p = _mixer(seed=1)
    b, s = 2, 32
    x = _x(b, s, cfg.d_model, seed=1)
    jstate = jssm.mamba_init_state(jcfg, b, jnp.float32)
    state = ssm.mamba_init_state(cfg, b, torch.float32, device=CPU)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jstate.items()}
    with torch.no_grad():
        prefill = ssm.mamba_forward(p, torch.from_numpy(x), cfg=cfg)
        errs, self_errs = [], []
        for t in range(s):
            jy, jstate = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                           jstate, cfg=jcfg)
            y, state = ssm.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                        state, cfg=cfg)
            assert y.shape == (b, 1, cfg.d_model)
            errs.append(_err(y.numpy(), jy))
            self_errs.append(float((y[:, 0] - prefill[:, t]).abs().max()))
    assert max(errs) < TOL, errs
    assert max(self_errs) < TOL, self_errs
    for key in ("conv", "h"):
        assert _err(state[key].numpy(), jstate[key]) < TOL, key


def _hybrid():
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), moe=None)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), moe=None)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return jcfg, cfg, jparams, params


def _calls(impl, pallas_norm):
    kw = dict(attention_impl=impl, attn_chunk=16,
              use_pallas_norm=pallas_norm, remat=False)
    return (JaxCall(compute_dtype=jnp.float32, **kw),
            CallConfig(compute_dtype=torch.float32, **kw))


@pytest.mark.parametrize("impl,pallas_norm", [("dense", False),
                                              ("pallas", True)])
def test_hybrid_forward_train_matches_reference(impl, pallas_norm):
    jcfg, cfg, jparams, params = _hybrid()
    assert cfg.layer_kinds() == ("mamba",) * 4 + ("attn",) + ("mamba",) * 3
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (2, 32))
    jcall, call = _calls(impl, pallas_norm)
    want, _ = jax_forward(jparams, jcfg, jcall,
                          {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, _ = forward_train(params, cfg, call,
                               {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 32, cfg.vocab)
    assert _err(got.numpy(), want) < TOL


def test_hybrid_decode_loop_matches_reference():
    b, s = 2, 8
    jcfg, cfg, jparams, params = _hybrid()
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (b, s))
    jcall, call = _calls("pallas", True)
    jcache = jax_init_cache(jcfg, b, s, jnp.float32)
    cache = init_cache(cfg, b, s, torch.float32, device=CPU)
    assert set(cache[0]) == {"conv", "h"} and set(cache[4]) == {"k", "v"}
    with torch.no_grad():
        prefill, _ = forward_train(params, cfg, call,
                                   {"tokens": torch.from_numpy(tokens)})
    errs, self_errs = [], []
    for t in range(s):
        jl, jcache = jax_decode(jparams, jcfg, jcall,
                                {"tokens": jnp.asarray(tokens[:, t])},
                                jcache, jnp.int32(t))
        lg, cache = forward_decode(params, cfg, call,
                                   {"tokens": torch.from_numpy(tokens[:, t])},
                                   cache, t)
        errs.append(_err(lg.numpy(), jl))
        self_errs.append(float((lg - prefill[:, t]).abs().max()))
    assert max(errs) < TOL, errs
    assert max(self_errs) < 5e-3, self_errs          # tests/test_models.py
    ours = convert.cache_to_numpy(cache, cfg)
    for i, (mine, ref) in enumerate(zip(ours, jcache)):
        assert set(mine) == set(ref)
        for key in mine:
            assert mine[key].shape == ref[key].shape, (i, key)
            assert _err(mine[key], ref[key]) < TOL, (i, key)
    again = convert.cache_from_reference(jax.tree.map(np.asarray, jcache),
                                         cfg, device=CPU)
    for c_ref, c_port in zip(again, cache):
        for key in c_port:
            assert torch.allclose(c_ref[key], c_port[key], atol=TOL)


def test_hybrid_init_params_shapes_and_count():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), moe=None)
    params = init_params(cfg, 0, device=CPU)
    assert param_count_actual(params) == param_count(cfg)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), moe=None)
    shapes = jax.eval_shape(partial(jax_init_params, jcfg),
                            jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    loaded = convert.model_params_from_reference(zeros, cfg, device=CPU)
    assert ({n: t.shape for n, t in loaded.state_dict().items()}
            == {n: t.shape for n, t in params.state_dict().items()})
    mixer = params.layers[0].mixer
    d, di = cfg.d_model, 2 * cfg.d_model
    assert abs(float(mixer.w_in.detach().std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert torch.equal(mixer.A_log[3], torch.log(torch.arange(1.0, 9.0)))
    assert tuple(mixer.w_out.shape) == (di, d)


def test_full_width_mixer_param_count():
    """The Jamba mixer the chip run builds: 403 570 688 parameters, the
    reference's init_mamba shapes at full width."""
    shapes = jax.eval_shape(partial(jssm.init_mamba,
                                    jax_get_config(ARCH)),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in shapes.values()) == 403_570_688


def test_jamba_with_moe_matches_reference():
    """Reduced jamba with its MoE layers (every other layer; the Mamba
    layers, the attention layer and the MoE MLPs together): the logits
    within 1e-4 and the summed aux loss within 1e-5 of the reference's,
    and its cache built per layer."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert [cfg.layer_has_moe(i) for i in range(4)] == [False, True] * 2
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    assert param_count_actual(params) == param_count(cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (2, 32))
    jcall, call = _calls("dense", False)
    want, want_aux = jax_forward(jparams, jcfg, jcall,
                                 {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = forward_train(params, cfg, call,
                                 {"tokens": torch.from_numpy(tokens)})
    assert _err(got.numpy(), want) < TOL
    assert abs(float(aux) - float(want_aux)) < 1e-5
    cache = init_cache(cfg, 1, 4, device=CPU)
    assert len(cache) == cfg.n_layers
