"""The port's xLSTM mixers (mLSTM, sLSTM) and the xlstm-1.3b model against
the reference's, reduced config (d 64, 4 heads, dh 32, chunk 16; 7 mLSTM
layers and one sLSTM), float32, the reference's weights carried across by
``convert``; max abs difference below 1e-4 unless stated:

- ``mlstm_forward`` and ``slstm_forward`` alone, S one chunk, several
  chunks and less than a chunk; an S that is no multiple of the chunk
  raises, as the reference asserts;
- ``mlstm_decode`` and ``slstm_decode`` alone for several steps, the state
  carried across, from the zero state and from a random non-zero one;
- every layer of the model, fed the reference's own hidden state, against
  the reference's ``_apply_layer`` (1e-4);
- ``forward_train`` logits under each of ``test_torch_model.IMPLS`` (the
  reference's Pallas RMSNorm in interpret mode);
- a ``forward_decode`` loop: every step's logits and the final cache
  against the reference's, the caches converted both ways, and decode
  against prefill within 5e-3 (the reference's bound,
  ``tests/test_models.py``);
- ``loss_fn``'s loss (1e-5) and whole gradient tree (1e-4 of each leaf's
  scale) against ``jax.value_and_grad``.

The whole model amplifies float32 rounding: the mLSTM divides by
max(|q·n|, exp(-m)), a sum that cancels, and the eight layers compound
it. The reference's own logits move by 2.2e-4 to 3.4e-3 when each
embedding entry moves by one ulp, and the port, rounding in another
order, is 5.6e-4 to 1.8e-3 from them (seeds 0-2, ``tests/xlstm_spread.py``;
ROADMAP Queue C). So the end-to-end checks hold the port to 1e-4 or to
``FLOOR_FACTOR`` times that one-ulp spread of the reference, measured in
the test for the same inputs, whichever is larger; the layer-by-layer
check holds each layer to 1e-4 outright.
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
from repro.models import loss_fn as jax_loss_fn
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                init_cache, loss_fn, ssm)

ARCH = "xlstm-1.3b"
TOL = 1e-4
CPU = "cpu"
# test_torch_model.IMPLS: (attention_impl, attn_chunk, use_pallas_norm)
IMPLS = [("dense", 512, False), ("chunked", 16, False),
         ("chunked", 512, False), ("pallas", 16, True)]
# the port may sit this many times the reference's own one-ulp spread
# from the reference (the module docstring)
FLOOR_FACTOR = 4


def _cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def _mixer(kind, seed=0):
    """(reference mixer params, the port's Weights) of one mixer."""
    jcfg, cfg = _cfgs()
    init = {"mlstm": jssm.init_mlstm, "slstm": jssm.init_slstm}[kind]
    jp = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, cfg, jp, convert.weights_from_reference(jp, device=CPU)


def _x(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def test_mixer_param_names_and_init():
    """The port's init has the reference's leaves and shapes, b_f at 3."""
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for kind in ("mlstm", "slstm"):
        jcfg, _, jp, _ = _mixer(kind)
        mine = getattr(ssm, f"init_{kind}")(cfg, gen, device=CPU)
        assert ({n: tuple(t.shape) for n, t in mine.named_parameters()}
                == {n: np.shape(v) for n, v in jp.items()})
        assert torch.all(mine.b_f == 3.0)
        np.testing.assert_array_equal(np.asarray(jp["b_f"]), 3.0)


@pytest.mark.parametrize("s", [16, 48, 8])     # one chunk, three, < chunk
def test_mlstm_forward_matches_reference(s):
    jcfg, cfg, jp, p = _mixer("mlstm")
    x = _x(np.random.RandomState(s), 2, s, cfg.d_model)
    want = jssm.mlstm_forward(jp, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        got = ssm.mlstm_forward(p, torch.from_numpy(x), cfg=cfg)
    assert got.shape == (2, s, cfg.d_model)
    assert _err(got.numpy(), want) < TOL


def test_mlstm_forward_rejects_a_ragged_length():
    _, cfg, _, p = _mixer("mlstm")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.mlstm_forward(p, torch.zeros((1, 24, cfg.d_model)), cfg=cfg)


@pytest.mark.parametrize("s", [16, 33])
def test_slstm_forward_matches_reference(s):
    jcfg, cfg, jp, p = _mixer("slstm", seed=1)
    x = _x(np.random.RandomState(s), 2, s, cfg.d_model)
    want = jssm.slstm_forward(jp, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        got = ssm.slstm_forward(p, torch.from_numpy(x), cfg=cfg)
    assert got.shape == (2, s, cfg.d_model)
    assert _err(got.numpy(), want) < TOL


def _random_state(kind, cfg, rs, b):
    """A non-zero state of the mixer's shapes: C, n (or c, n, h) ~ N(0, 1),
    n of the sLSTM positive, m finite."""
    h, di = cfg.n_heads, 2 * cfg.d_model
    dh = di // h
    if kind == "mlstm":
        return {"C": _x(rs, b, h, dh, dh), "n": _x(rs, b, h, dh),
                "m": _x(rs, b, h)}
    return {"c": _x(rs, b, di), "n": 1 + np.abs(_x(rs, b, di)),
            "h": 0.5 * _x(rs, b, di), "m": _x(rs, b, di)}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("start", ["zero", "random"])
def test_decode_steps_match_reference(kind, start):
    """Six steps of the mixer's decode, each from the state the last step
    returned: outputs and states against the reference's."""
    jcfg, cfg, jp, p = _mixer(kind, seed=2)
    b = 2
    rs = np.random.RandomState(3)
    init_state = getattr(jssm, f"{kind}_init_state")
    jstate = (jax.tree.map(np.asarray, init_state(jcfg, b, jnp.float32))
              if start == "zero" else _random_state(kind, cfg, rs, b))
    state = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    if start == "zero":
        mine = getattr(ssm, f"{kind}_init_state")(cfg, b, torch.float32,
                                                  CPU)
        assert all(torch.equal(mine[k], state[k]) for k in state)
    jdecode = getattr(jssm, f"{kind}_decode")
    decode = getattr(ssm, f"{kind}_decode")
    jstate = {k: jnp.asarray(v) for k, v in jstate.items()}
    for _ in range(6):
        x = _x(rs, b, 1, cfg.d_model)
        want, jstate = jdecode(jp, jnp.asarray(x), jstate, cfg=jcfg)
        with torch.no_grad():
            got, state = decode(p, torch.from_numpy(x), state, cfg=cfg)
        assert got.shape == (b, 1, cfg.d_model)
        assert _err(got.numpy(), want) < TOL
        for k in jstate:
            assert state[k].shape == jstate[k].shape, k
            assert state[k].dtype == torch.float32, k
            err = _err(state[k].numpy(), jstate[k])
            assert err < TOL * max(1.0, float(np.abs(jstate[k]).max())), k


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_forward(kind):
    """The recurrent form token by token against the mixer's forward (the
    chunked form, for the mLSTM) on the same input, within 5e-3."""
    _, cfg, _, p = _mixer(kind, seed=4)
    x = torch.from_numpy(_x(np.random.RandomState(5), 2, 32, cfg.d_model))
    with torch.no_grad():
        full = getattr(ssm, f"{kind}_forward")(p, x, cfg=cfg)
        state = getattr(ssm, f"{kind}_init_state")(cfg, 2, torch.float32,
                                                   CPU)
        steps = []
        for t in range(32):
            y, state = getattr(ssm, f"{kind}_decode")(p, x[:, t:t + 1],
                                                      state, cfg=cfg)
            steps.append(y)
    assert float((torch.cat(steps, dim=1) - full).abs().max()) < 5e-3


def _setup(seed=0):
    jcfg, cfg = _cfgs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return jcfg, cfg, jparams, params


def _nudged(jparams, seed=100):
    """The reference's params with every embedding entry moved one ulp up
    or down at random."""
    e = np.asarray(jparams["embed"])
    up = np.random.RandomState(seed).random_sample(e.shape) < 0.5
    toward = np.where(up, np.inf, -np.inf).astype(np.float32)
    return dict(jparams, embed=jnp.asarray(np.nextafter(e, toward)))


def _within(err, floor, tol=TOL) -> bool:
    return err < max(tol, FLOOR_FACTOR * floor)


def _calls(impl, chunk, pallas_norm):
    kw = dict(attention_impl=impl, attn_chunk=chunk,
              use_pallas_norm=pallas_norm, remat=False)
    return (JaxCall(compute_dtype=jnp.float32, **kw),
            CallConfig(compute_dtype=torch.float32, **kw))


def test_model_layers():
    _, cfg, _, params = _setup()
    kinds = [lp.kind for lp in params.layers]
    assert kinds == ["mlstm"] * 7 + ["slstm"]
    assert all(not hasattr(lp, "mlp") and lp.cross is None
               for lp in params.layers)


@pytest.mark.parametrize("impl,chunk,pallas_norm", [IMPLS[0], IMPLS[3]])
def test_each_layer_matches_reference(impl, chunk, pallas_norm):
    """Layer i of the port applied to the reference's hidden state before
    layer i: the same output as the reference's layer, within 1e-4."""
    from repro.models import model as jmodel
    from repro_torch.models import model as tmodel
    jcfg, cfg, jparams, params = _setup()
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (2, 32))
    jcall, call = _calls(impl, chunk, pallas_norm)
    jx = jparams["embed"][jnp.asarray(tokens)]
    positions = jnp.arange(32)
    for i, kind in enumerate(jcfg.layer_kinds()):
        lp = jax.tree.map(lambda a: a[0], jparams["blocks"][i])
        want, _, _ = jmodel._apply_layer(
            jcfg, jcall, kind, lp, jx, positions=positions, mem=None,
            cache=None, max_seq=None, use_kernel_scan=False)
        with torch.no_grad():
            got, _, _ = tmodel._apply_layer(
                cfg, call, params.layers[i], torch.from_numpy(np.array(jx)),
                positions=torch.arange(32), mem=None, cache=None)
        assert _err(got.numpy(), want) < TOL, (i, kind)
        jx = want


@pytest.mark.parametrize("impl,chunk,pallas_norm", IMPLS)
def test_forward_train_matches_reference(impl, chunk, pallas_norm):
    jcfg, cfg, jparams, params = _setup()
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (2, 32))
    jcall, call = _calls(impl, chunk, pallas_norm)
    jbatch = {"tokens": jnp.asarray(tokens)}
    want, _ = jax_forward(jparams, jcfg, jcall, jbatch)
    floor = _err(jax_forward(_nudged(jparams), jcfg, jcall, jbatch)[0],
                 want)
    with torch.no_grad():
        got, aux = forward_train(params, cfg, call,
                                 {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    err = _err(got.numpy(), want)
    assert _within(err, floor), (err, floor)


def _jax_decode_loop(jparams, jcfg, jcall, tokens):
    b, s = tokens.shape
    jcache = jax_init_cache(jcfg, b, s, jnp.float32)
    logits = []
    for t in range(s):
        jl, jcache = jax_decode(jparams, jcfg, jcall,
                                {"tokens": jnp.asarray(tokens[:, t])},
                                jcache, jnp.int32(t))
        logits.append(np.asarray(jl))
    return np.stack(logits), jax.tree.map(np.asarray, jcache)


@pytest.mark.parametrize("impl,chunk,pallas_norm", [IMPLS[0], IMPLS[3]])
def test_decode_loop_matches_reference(impl, chunk, pallas_norm):
    b, s = 2, 8
    jcfg, cfg, jparams, params = _setup(seed=1)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (b, s))
    jcall, call = _calls(impl, chunk, pallas_norm)
    want, ref = _jax_decode_loop(jparams, jcfg, jcall, tokens)
    want2, ref2 = _jax_decode_loop(_nudged(jparams), jcfg, jcall, tokens)
    cache = init_cache(cfg, b, s, torch.float32, device=CPU)
    with torch.no_grad():
        prefill, _ = forward_train(params, cfg, call,
                                   {"tokens": torch.from_numpy(tokens)})
    got, self_errs = [], []
    for t in range(s):
        lg, cache = forward_decode(params, cfg, call,
                                   {"tokens": torch.from_numpy(tokens[:, t])},
                                   cache, t)
        got.append(lg.numpy())
        self_errs.append(float((lg - prefill[:, t]).abs().max()))
    err, floor = _err(np.stack(got), want), _err(want2, want)
    assert _within(err, floor), (err, floor)
    assert max(self_errs) < 5e-3, self_errs
    ours = convert.cache_to_numpy(cache, cfg)
    assert [sorted(c) for c in ours] == [["C", "m", "n"]] * 7 \
        + [["c", "h", "m", "n"]]
    for i, (mine, leaf, leaf2) in enumerate(zip(ours, ref, ref2)):
        for key in leaf:
            assert mine[key].shape == leaf[key].shape, (i, key)
            scale = max(1.0, float(np.abs(leaf[key]).max()))
            err = _err(mine[key], leaf[key]) / scale
            assert _within(err, _err(leaf2[key], leaf[key]) / scale), \
                (i, key, err)
    back = convert.cache_from_reference(ref, cfg, device=CPU)
    for c_ref, c_port in zip(back, cache):
        assert set(c_ref) == set(c_port)
        for key in c_ref:
            assert c_ref[key].dtype == c_port[key].dtype
            assert c_ref[key].shape == c_port[key].shape
    assert np.array_equal(convert.cache_to_numpy(back, cfg)[0]["C"],
                          ref[0]["C"])


def _jax_loss_and_grads(jparams, jcfg, kw, tokens, labels):
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, JaxCall(compute_dtype=jnp.float32,
                                               **kw),
                              {"tokens": jnp.asarray(tokens),
                               "labels": jnp.asarray(labels)}),
        has_aux=True)(jparams)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrads))[0]
    return float(jloss), flat


def test_loss_fn_grads_match_reference():
    jcfg, cfg, jparams, params = _setup(seed=2)
    rs = np.random.RandomState(2)
    b, s = 2, 32
    tokens = rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    kw = dict(attention_impl="dense", remat=False)
    jloss, want = _jax_loss_and_grads(jparams, jcfg, kw, tokens, labels)
    _, want2 = _jax_loss_and_grads(_nudged(jparams), jcfg, kw, tokens,
                                   labels)
    loss, _ = loss_fn(params, cfg, CallConfig(compute_dtype=torch.float32,
                                              **kw),
                      {"tokens": torch.from_numpy(tokens),
                       "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    got = jax.tree_util.tree_flatten_with_path(
        convert.model_params_to_reference(
            {n: p.grad for n, p in params.named_parameters()}, cfg))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w), (_, w2) in zip(got, want, want2):
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err, floor = _err(g, w) / scale, _err(w2, w) / scale
        assert _within(err, floor), (path, err, floor)
