"""The port's serving entry point on the CPU, and its greedy loop against
the reference's (``repro.launch.serve``'s loop over ``forward_decode``)
with the reference's weights carried across and one prompt (and, for the
vision model, one stub memory): wherever the reference's top-2 logit gap
exceeds the logits' tolerance, both pick the same token; the comparison
stops at the first step where it does not (a near tie may go either way,
and the sequences then part). The tolerance is 1e-4, and 2e-3 for
xlstm-1.3b, whose float32 logits are determined only to about 1e-3 (the
reference's own logits move by up to 3.4e-3 when its embeddings move by
one ulp; ``tests/xlstm_spread.py``, ``tests/test_torch_xlstm.py``).
musicgen-medium takes frame embeddings: the prompt's frames one by one,
then ``0.0 * frame_emb[:, :1]`` at every generated step, as the
reference's ``serve`` feeds them (``src/repro/launch/serve.py:69``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import CallConfig as JaxCall
from repro.models import forward_decode as jax_decode
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import greedy_generate, serve
from repro_torch.models import CallConfig, init_cache

TOL = 1e-4
ARCHS = ["smollm-135m", "qwen3-14b", "xlstm-1.3b", "llama-3.2-vision-11b",
         "musicgen-medium"]
LOGITS_TOL = {"xlstm-1.3b": 2e-3}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu(arch):
    out = serve(arch, reduced=True, batch=2, prompt_len=4, gen=6,
                verbose=False, device="cpu")
    toks = out["tokens"]
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < get_config(arch).reduced().vocab)).all()
    assert out["seconds"] > 0


def _jax_greedy(params, cfg, call, prompt, gen, extra):
    """The reference serve()'s loop, with its logits kept; ``prompt`` is
    tokens [B, P] or, for a config without an embedding table, frame_emb
    [B, P, D], whose generated steps get ``0.0 * frame_emb[:, :1]``;
    ``extra`` (the stub memory) goes to every step."""
    b, prompt_len = prompt.shape[:2]
    cache = jax_init_cache(cfg, b, prompt_len + gen, jnp.float32)
    decode = jax.jit(lambda p, c, bt, pos: jax_decode(p, cfg, call, bt, c,
                                                      pos))
    extra = {k: jnp.asarray(v) for k, v in extra.items()}
    prompt = jnp.asarray(prompt)
    for t in range(prompt_len):
        step = ({"tokens": prompt[:, t]} if cfg.embed_inputs
                else {"frame_emb": prompt[:, t:t + 1]})
        logits, cache = decode(params, cache, {**step, **extra},
                               jnp.int32(t))
    out_t, out_l = [], []
    for t in range(prompt_len, prompt_len + gen):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out_t.append(np.asarray(tok))
        out_l.append(np.asarray(logits))
        if t < prompt_len + gen - 1:
            step = ({"tokens": tok} if cfg.embed_inputs
                    else {"frame_emb": 0.0 * prompt[:, :1]})
            logits, cache = decode(params, cache, {**step, **extra},
                                   jnp.int32(t))
    return np.stack(out_t, axis=1), out_l


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    b, prompt_len, gen = 2, 6, 10
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rs = np.random.RandomState(3)
    if cfg.embed_inputs:
        prompt = rs.randint(0, cfg.vocab, (b, prompt_len))
    else:
        prompt = (0.02 * rs.standard_normal((b, prompt_len, cfg.d_model))
                  ).astype(np.float32)
    jcall = JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                    remat=False)
    call = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                      remat=False)
    extra = {}
    if cfg.cross_attn is not None:
        extra["vision_mem"] = (0.02 * np.random.RandomState(4).standard_normal(
            (b, cfg.cross_attn.n_mem_tokens, cfg.d_model))).astype(np.float32)
    tol = LOGITS_TOL.get(arch, TOL)
    want, want_logits = _jax_greedy(jparams, jcfg, jcall, prompt, gen, extra)
    cache = init_cache(cfg, b, prompt_len + gen, torch.float32,
                       device="cpu")
    with torch.no_grad():
        got, got_logits = greedy_generate(
            params, cfg, call,
            {("tokens" if cfg.embed_inputs else "frame_emb"):
             torch.from_numpy(prompt),
             **{k: torch.from_numpy(v) for k, v in extra.items()}},
            cache, prompt_len, gen)
    assert got.shape == (b, gen)
    got = got.numpy()
    compared = 0
    for step, (jl, pl) in enumerate(zip(want_logits, got_logits)):
        top2 = np.sort(jl, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() <= tol:
            break
        assert np.array_equal(got[:, step], want[:, step]), step
        assert float(np.max(np.abs(pl.numpy() - jl))) < tol
        compared += 1
    assert compared >= gen // 2, compared


def test_serve_passes_the_memory_to_every_step(monkeypatch):
    """serve() on the vision model: every decode step (prompt and
    generated tokens) gets the same stub memory [batch, 7, d_model]."""
    from repro_torch.launch import serve as serve_mod
    seen = []
    decode = serve_mod.forward_decode

    def spy(params, cfg, call, batch, cache, pos):
        seen.append(batch.get("vision_mem"))
        return decode(params, cfg, call, batch, cache, pos)

    monkeypatch.setattr(serve_mod, "forward_decode", spy)
    serve("llama-3.2-vision-11b", batch=2, prompt_len=3, gen=4,
          verbose=False, device="cpu")
    assert len(seen) == 3 + 4 - 1
    assert seen[0] is not None and tuple(seen[0].shape) == (2, 7, 64)
    assert all(m is seen[0] for m in seen)
    assert abs(float(seen[0].std()) - 0.02) < 0.005


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generated_frames_are_zeros_of_the_prompts_dtype(dtype, monkeypatch):
    """musicgen-medium under greedy_generate: the prompt's frames go in one
    by one, then every generated step gets 0.0 * frame_emb[:, :1], zeros
    of the prompt's own dtype (bf16 stays bf16), which forward_decode
    casts to the compute dtype as the reference's ``_embed`` does."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params
    dt = getattr(torch, dtype)
    cfg = get_config("musicgen-medium").reduced()
    params = init_params(cfg, 0, device="cpu", dtype=dt)
    call = CallConfig(compute_dtype=dt, attention_impl="dense", remat=False)
    prompt = (0.02 * torch.randn((2, 3, cfg.d_model),
                                 generator=torch.Generator().manual_seed(0))
              ).to(dt)
    seen = []
    decode = serve_mod.forward_decode

    def spy(params, cfg, call, batch, cache, pos):
        seen.append(batch["frame_emb"])
        return decode(params, cfg, call, batch, cache, pos)

    monkeypatch.setattr(serve_mod, "forward_decode", spy)
    cache = init_cache(cfg, 2, 3 + 4, dt, device="cpu")
    with torch.no_grad():
        toks, logits = greedy_generate(params, cfg, call,
                                       {"frame_emb": prompt}, cache, 3, 4)
    assert len(seen) == 3 + 4 - 1
    for t in range(3):
        assert torch.equal(seen[t], prompt[:, t:t + 1])
    for f in seen[3:]:
        assert f.dtype == dt and tuple(f.shape) == (2, 1, cfg.d_model)
        assert not f.any()
    assert toks.shape == (2, 4) and all(lg.dtype == torch.float32
                                        and torch.isfinite(lg).all()
                                        for lg in logits)
