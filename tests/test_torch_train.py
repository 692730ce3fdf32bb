"""The port's training path against the reference's: AdamW (with and
without int8 moments) and the int8 gradient compressor, 5 steps of
``make_train_step`` from the same params and batches, the data pipeline,
checkpoints across the two packages, and the port's versions of the
reference's end-to-end training tests (``tests/test_system.py:17-43``)
and substrate tests (``tests/test_substrates.py``).

The pipeline's draws are the port's own (``data/pipeline.py``), so the
step comparisons carry the reference's batches across; the pipeline is
held to the reference's distribution instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import global_batch as jax_global_batch
from repro.distributed.steps import make_train_step as jax_make_train_step
from repro.models import CallConfig as JaxCall
from repro.models import init_params as jax_init_params
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, batch_shard, global_batch
from repro_torch.distributed.steps import (make_prefill_step,
                                           make_serve_step, make_train_step)
from repro_torch.launch.train import train
from repro_torch.models import CallConfig, init_cache, init_params
from repro_torch.optim import adamw

CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---- optimizer --------------------------------------------------------------

def test_adamw_matches_reference_math():
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=1e9,
                            warmup_steps=1)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    p2, st2, _ = adamw.apply_updates(cfg, p, g, adamw.init_opt_state(cfg, p))
    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.05 * np.array([0.1, 0.2, -0.3]) ** 2
    expect = np.array([1.0, -2.0, 3.0]) \
        - 1e-2 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + 1e-8)
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-5)
    assert int(st2["step"]) == 1


@pytest.mark.parametrize("quantized", [False, True])
def test_apply_updates_matches_reference(quantized):
    """Three steps from the same params and grads (one leaf past
    QUANT_MIN_SIZE, so with ``quantized_state`` its moments are int8 rows;
    clipping and warm-up active): params within 1e-6 of their scale; with
    int8 moments all but 1e-4 of them, the moments within one int8 step
    (as many flips at most) and their scales within 1e-6 relative."""
    cfg_kw = dict(lr=1e-2, grad_clip=0.5, warmup_steps=2,
                  quantized_state=quantized)
    rs = np.random.RandomState(0)
    p_np = {"w": rs.standard_normal((adamw.QUANT_MIN_SIZE // 1024, 1024)
                                    ).astype(np.float32),
            "b": rs.standard_normal((300,)).astype(np.float32)}
    grads = [{k: (0.01 * rs.standard_normal(v.shape)).astype(np.float32)
              for k, v in p_np.items()} for _ in range(3)]
    jcfg = jadamw.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jst = jadamw.init_opt_state(jcfg, jp)
    cfg = adamw.AdamWConfig(**cfg_kw)
    p = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    st = adamw.init_opt_state(cfg, p)
    assert isinstance(st["m"]["w"], dict) == quantized
    assert not isinstance(st["m"]["b"], dict)
    for g in grads:
        jp, jst, jm = jadamw.apply_updates(jcfg, jp, {k: jnp.asarray(v)
                                                      for k, v in g.items()},
                                           jst)
        p, st, m = adamw.apply_updates(cfg, p, {k: torch.from_numpy(v)
                                                for k, v in g.items()}, st)
        assert _rel(m["grad_norm"].item(), jm["grad_norm"]) < 1e-6
        assert _rel(m["lr"].item(), jm["lr"]) < 1e-7
    for k in p:
        # int8 rows: the reference's float32 moments can differ from the
        # port's in the last bit (XLA's association), and an element near
        # a rounding boundary then lands one int8 step away; a few dozen
        # of 4M do after three steps, and move their params
        off = np.abs(p[k].numpy() - np.asarray(jp[k])) \
            > 1e-6 * np.abs(np.asarray(jp[k])).max()
        assert off.sum() <= (1e-4 * off.size if quantized else 0), k
    for slot in ("m", "v"):
        mine, ref = st[slot]["w"], jst[slot]["w"]
        if quantized:
            dq = np.abs(mine["q"].numpy().astype(np.int32)
                        - np.asarray(ref["q"]).astype(np.int32))
            assert dq.max() <= 1 and (dq > 0).sum() <= 1e-4 * dq.size, slot
            assert _rel(mine["s"].numpy(), ref["s"]) < 1e-6, slot
        else:
            assert _rel(mine.numpy(), ref) < 1e-5, slot
    assert int(st["step"]) == int(jst["step"]) == 3


def test_optimizer_reduces_quadratic_loss():
    cfg = adamw.AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=1)
    target = torch.linspace(-1, 1, 512)
    p = {"w": torch.zeros(512)}
    st = adamw.init_opt_state(cfg, p)
    l0 = float(torch.sum(target ** 2))
    for _ in range(60):
        p, st, _ = adamw.apply_updates(cfg, p, {"w": 2 * (p["w"] - target)},
                                       st)
    assert float(torch.sum((p["w"] - target) ** 2)) < 0.05 * l0


def test_compress_grad_matches_reference():
    """20 steps of error feedback on the same gradients: int8 blocks
    within one step of the reference's, scales and errors within 1e-6 of
    the gradient's scale; the accumulated decompressed gradient within 1%
    of the true sum (the reference's own property)."""
    rs = np.random.RandomState(1)
    g = (0.3 * rs.standard_normal((1000,))).astype(np.float32)
    jerr, err = jnp.zeros(1000), torch.zeros(1000)
    acc, acc_true = torch.zeros(1000), torch.zeros(1000)
    for i in range(20):
        gi = g * (1 + 0.1 * i)
        jq, js, jerr = jadamw.compress_grad(jnp.asarray(gi), jerr)
        q, s, err = adamw.compress_grad(torch.from_numpy(gi), err)
        assert q.dtype == torch.int8 and q.shape == (4, adamw.BLOCK)
        assert np.abs(q.numpy().astype(int) - np.asarray(jq)).max() <= 1
        assert _rel(s.numpy(), js) < 1e-6
        assert float(np.max(np.abs(err.numpy() - np.asarray(jerr)))) \
            < 1e-6 * np.abs(gi).max() + np.asarray(js).max()
        acc += adamw.decompress_grad(q, s, gi.shape, gi.size)
        acc_true += torch.from_numpy(gi)
    assert float(torch.linalg.norm(acc - acc_true)
                 / torch.linalg.norm(acc_true)) < 1e-2


# ---- train step ---------------------------------------------------------------

def _jax_batches(jcfg, n, b=4, s=32, seed=3):
    shape = ShapeConfig("t", "train", s, b)
    return [jax_global_batch(jcfg, shape, JaxDataConfig(seed=seed), step)
            for step in range(n)]


@pytest.mark.parametrize("arch", ["smollm-135m", "dbrx-132b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_make_train_step_matches_reference(arch):
    """5 steps of the reference's jitted train step and the port's, from
    the reference's params and batches (the reference trainer's CallConfig
    and AdamWConfig(lr=1e-3, warmup_steps=20)): every step's metrics within
    1e-5 relative, the final params and first moments leaf by leaf within
    1e-4 of the leaf's scale, the second moments (squared grads) within
    2e-4."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.model_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    jopt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=20)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20)
    jstep = jax.jit(jax_make_train_step(
        jcfg, JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                      remat=False), jopt_cfg))
    step = make_train_step(cfg, CallConfig(compute_dtype=torch.float32,
                                           attention_impl="dense",
                                           remat=False), opt_cfg)
    jst, st = jadamw.init_opt_state(jopt_cfg, jparams), \
        adamw.init_opt_state(opt_cfg, params)
    for jb in _jax_batches(jcfg, 5):
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        jparams, jst, jm = jstep(jparams, jst, jb)
        params, st, m = step(params, st, batch)
        for key in ("loss", "nll", "aux", "zloss", "grad_norm", "lr"):
            assert abs(m[key].item() - float(jm[key])) \
                <= 1e-5 * max(abs(float(jm[key])), 1e-3), key
    got = convert.model_params_to_reference(params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, jparams))[0]):
        assert _rel(a, b) < 1e-4, path
    assert int(st["step"]) == 5
    got_opt = convert.opt_state_to_reference(st, cfg)
    for slot, tol in (("m", 1e-4), ("v", 2e-4)):     # v: squared grads
        for a, b in zip(jax.tree.leaves(got_opt[slot]),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     jst[slot]))):
            assert _rel(a, b) < tol, slot


def test_serve_and_prefill_steps():
    cfg = get_config("dbrx-132b").reduced()
    params = init_params(cfg, 0, device=CPU)
    call = CallConfig(compute_dtype=torch.float32, remat=False)
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    nxt = make_prefill_step(cfg, call)(params, {"tokens": tokens})
    serve_step = make_serve_step(cfg, call)
    cache = init_cache(cfg, 2, 6, torch.float32, device=CPU)
    for t in range(6):
        tok, cache = serve_step(params, cache, {"tokens": tokens[:, t]}, t)
    assert nxt.dtype == tok.dtype == torch.int32 and nxt.shape == (2,)
    assert torch.equal(tok, nxt)      # capacity does not bind at 2 tokens


# ---- data pipeline ------------------------------------------------------------

def test_data_pipeline_determinism_and_sharding():
    cfg = get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", "train", 32, 8)
    dcfg = DataConfig(seed=3)
    a = global_batch(cfg, shape, dcfg, step=5, device=CPU)
    b = global_batch(cfg, shape, dcfg, step=5, device=CPU)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    c = global_batch(cfg, shape, dcfg, step=6, device=CPU)
    assert not torch.equal(a["tokens"], c["tokens"])
    s0 = batch_shard(cfg, shape, dcfg, 5, 0, 4, device=CPU)
    s1 = batch_shard(cfg, shape, dcfg, 5, 1, 4, device=CPU)
    assert s0["tokens"].shape == (2, 32)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    with pytest.raises(ValueError, match="shards"):
        batch_shard(cfg, shape, dcfg, 5, 0, 3, device=CPU)


@pytest.mark.parametrize("step,n_shards", [(0, 1), (7, 2), (999, 8),
                                           (13, 4)])
def test_pipeline_shard_union(step, n_shards):
    """Shards tile the global batch deterministically."""
    cfg = get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", "train", 16, 8)
    dcfg = DataConfig(seed=1)
    shards = [batch_shard(cfg, shape, dcfg, step, i, n_shards, device=CPU)
              for i in range(n_shards)]
    assert sum(s["tokens"].shape[0] for s in shards) == 8
    again = batch_shard(cfg, shape, dcfg, step, 0, n_shards, device=CPU)
    assert torch.equal(shards[0]["tokens"], again["tokens"])


def test_pipeline_follows_reference_distribution():
    """The port's tokens less the reference's drift follow the Zipf
    unigram the reference samples: the top rank's frequency and the mean
    log-rank within four standard errors of the distribution's, as the
    reference's own batch of the same shape is."""
    cfg, jcfg = get_config("smollm-135m").reduced(), \
        jax_get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", "train", 255, 16)
    p = np.arange(1, cfg.vocab + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    logr = np.log(np.arange(1, cfg.vocab + 1))
    drift = (np.arange(256) * 7) % (cfg.vocab // 7)
    n = 16 * 256
    for toks in (
            global_batch(cfg, shape, DataConfig(seed=0), 0, device=CPU),
            {k: torch.from_numpy(np.array(v)) for k, v in jax_global_batch(
                jcfg, shape, JaxDataConfig(seed=0), 0).items()}):
        full = np.concatenate([toks["tokens"].numpy(),
                               toks["labels"].numpy()[:, -1:]], axis=1)
        base = (full - drift[None, :]) % cfg.vocab
        f0 = np.mean(base == 0)
        assert abs(f0 - p[0]) < 4 * np.sqrt(p[0] * (1 - p[0]) / n)
        mean, var = (p * logr).sum(), (p * logr ** 2).sum() \
            - (p * logr).sum() ** 2
        assert abs(np.mean(logr[base]) - mean) < 4 * np.sqrt(var / n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_frame_embedding_inputs_match_reference(kind):
    """musicgen-medium (no embedding table): the batch and the dry run's
    input stand-ins carry frame_emb where a token model carries tokens,
    with the reference's keys, shapes and dtypes; the pipeline's frames
    are 0.02 N(0, 1) float32, as the reference draws them (the draws
    themselves are the port's own, ROADMAP Queue C)."""
    from repro.distributed.steps import input_specs as jax_input_specs
    from repro_torch.distributed.steps import input_specs
    arch = "musicgen-medium"
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    shape = ShapeConfig("t", kind, 64, 8)
    want = jax_input_specs(jcfg, shape, jnp.float32)
    got = input_specs(cfg, shape, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    if kind != "train":
        return
    batch = global_batch(cfg, shape, DataConfig(seed=3), 0, device=CPU)
    jb = jax_global_batch(jcfg, shape, JaxDataConfig(seed=3), 0)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batch.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
    for emb in (batch["frame_emb"].numpy(), np.asarray(jb["frame_emb"])):
        assert abs(float(emb.std()) - 0.02) < 0.001
        assert abs(float(emb.mean())) < 0.001
    assert ((batch["labels"] >= 0) & (batch["labels"] < cfg.vocab)).all()


# ---- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip_and_commit_cut(tmp_path):
    c = ck.MandatorCheckpointer(tmp_path, n_controllers=3)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    # only 1 of 3 shards written -> no commit (a torn checkpoint)
    c.write_shard(0, 1, tree)
    assert not c.try_commit(1, step=10)
    assert c.latest_committed() is None and c.restore(tree) is None
    c.write_shard(1, 1, tree)
    assert not c.try_commit(1, step=10, acks=[True, False, True])
    assert c.try_commit(1, step=10)        # quorum (2 of 3) -> commit
    step, restored = c.restore(tree)
    assert step == 10 and torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.int32
    tree2 = {"a": 2 * tree["a"], "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    for i in range(3):
        c.write_shard(i, 2, tree2)
    c.try_commit(2, step=20)
    step, restored = c.restore(tree)
    assert step == 20 and torch.equal(restored["b"]["c"], tree2["b"]["c"])
    # a newer version with one shard of three stays uncommitted
    c.write_shard(2, 3, tree)
    assert not c.try_commit(3, step=30)
    assert c.restore(tree)[0] == 20
    assert (tmp_path / "c0" / "v1" / "state.npz").exists()
    assert (tmp_path / "c0" / "v1" / "state.ok").exists()


def _trained(arch="jamba-1.5-large-398b"):
    """A reduced model and its AdamW state after two port steps."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device=CPU)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20)
    st = adamw.init_opt_state(opt_cfg, params)
    step = make_train_step(cfg, CallConfig(compute_dtype=torch.float32,
                                           attention_impl="dense",
                                           remat=False), opt_cfg)
    shape = ShapeConfig("t", "train", 16, 2)
    for i in range(2):
        params, st, _ = step(params, st, global_batch(
            cfg, shape, DataConfig(), i, device=CPU))
    return cfg, params, st


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b"])
def test_checkpoint_port_to_reference(tmp_path, arch):
    """The port's save restores in the reference (its restore with its own
    templates): every param and moment equal."""
    cfg, params, st = _trained(arch)
    ck.save(tmp_path / "ck", 7, params, st)
    jcfg = jax_get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    jst = jadamw.init_opt_state(jadamw.AdamWConfig(), jparams)
    step, rp, ro = jck.restore(tmp_path / "ck", jparams, jst)
    assert step == 7 and int(ro["step"]) == 2
    want_p = convert.model_params_to_reference(params)
    want_o = convert.opt_state_to_reference(st, cfg)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(want_p)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(ro), jax.tree.leaves(want_o)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ["arctic-480b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b"])
def test_checkpoint_reference_to_port(tmp_path, arch):
    """The reference's save restores in the port, into its templates."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    jopt = jadamw.AdamWConfig()
    jst = jadamw.init_opt_state(jopt, jparams)
    grads = jax.tree.map(lambda a: 0.01 * jnp.ones_like(a), jparams)
    jparams, jst, _ = jadamw.apply_updates(jopt, jparams, grads, jst)
    jck.save(tmp_path / "ck", 11, jparams, jst)
    params = init_params(cfg, 0, device=CPU)
    st = adamw.init_opt_state(adamw.AdamWConfig(), params)
    step, params, st = ck.restore(tmp_path / "ck", params, st)
    assert step == 11 and int(st["step"]) == 1
    for a, b in zip(jax.tree.leaves(convert.model_params_to_reference(
            params)), jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_array_equal(a, b)
    for slot in ("m", "v"):
        for a, b in zip(jax.tree.leaves(convert.opt_state_to_reference(
                st, cfg)[slot]), jax.tree.leaves(jax.tree.map(
                    np.asarray, jst[slot]))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,leaf,layers", [
    ("smollm-135m", "mixer.wq", (0, 1)),
    ("xlstm-1.3b", "mixer.r_f", (7,)),            # an sLSTM's [H, dh, dh]
    ("xlstm-1.3b", "mixer.w_i", (0, 1)),          # an mLSTM gate's
    ("llama-3.2-vision-11b", "cross.wk", (4,)),   # the cross layer's
])
def test_quantized_opt_state_converts_both_ways(arch, leaf, layers):
    """An int8 moment ({'q', 's'}) of a stacked block leaf maps to the
    reference's [R, ...] {'q', 's'} and back exactly."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device=CPU)
    st = adamw.init_opt_state(adamw.AdamWConfig(), params)
    g = torch.Generator().manual_seed(0)
    for slot in ("m", "v"):
        for layer in layers:
            name = f"layers.{layer}.{leaf}"
            w = st[slot][name]
            st[slot][name] = {
                "q": torch.randint(-127, 128, w.shape, dtype=torch.int8,
                                   generator=g),
                "s": torch.rand(w.shape[:-1] + (1,), generator=g)}
    tree = convert.opt_state_to_reference(st, cfg)
    node = tree["m"]["blocks"][layers[0] % cfg.block_period]
    for key in leaf.split("."):
        node = node[key]
    repeats = cfg.n_layers // cfg.block_period
    assert set(node) == {"q", "s"} and node["q"].shape[0] == repeats
    back = convert.opt_state_from_reference(tree, params, device=CPU)
    for slot in ("m", "v"):
        for n, v in st[slot].items():
            if isinstance(v, dict):
                assert all(torch.equal(v[k], back[slot][n][k]) for k in v)
            else:
                assert torch.equal(v, back[slot][n])


# ---- end to end (tests/test_system.py:17-43) -------------------------------

def test_train_loss_decreases():
    out = train("smollm-135m", steps=40, batch=4, seq=32, verbose=False,
                device=CPU)
    assert out["losses"][-1] < out["losses"][0] - 0.1


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "llama-3.2-vision-11b"])
def test_train_runs_the_new_mixers(arch):
    """launch.train through the xLSTM mixers and cross-attention (the
    pipeline draws the vision model's stub memory): every step committed,
    finite losses, and every parameter moved from its initial value (each
    one gets a gradient; the reference's AdamW moves a parameter whose
    gradient is nonzero)."""
    out = train(arch, steps=4, batch=2, seq=16, verbose=False, device=CPU)
    losses = out["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert out["commits"] == [4]
    start = init_params(get_config(arch).reduced(), 0, device=CPU)
    for (name, p0), p in zip(start.named_parameters(),
                             out["params"].parameters()):
        assert not torch.equal(p0, p), name


def test_train_survives_pod_crash_elastic():
    out = train("smollm-135m", steps=20, batch=6, seq=16, n_pods=3,
                crash_pod_at=8, verbose=False, device=CPU)
    assert len(out["losses"]) == 20                 # every step committed
    assert np.isfinite(out["losses"]).all()
    # the surviving controllers kept committing after the crash
    assert out["commits"][0] > 8


def test_checkpoint_resume_exact(tmp_path):
    a = train("smollm-135m", steps=20, batch=2, seq=16,
              ckpt_dir=str(tmp_path / "ck"), ckpt_every=10, verbose=False,
              device=CPU)
    # a fresh run restores at step 20 and must take no further steps
    b = train("smollm-135m", steps=20, batch=2, seq=16,
              ckpt_dir=str(tmp_path / "ck"), ckpt_every=10, verbose=False,
              device=CPU)
    assert b["losses"] == []
    for (na, pa), (nb, pb) in zip(a["params"].named_parameters(),
                                  b["params"].named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    assert int(b["opt_state"]["step"]) == 20


def test_train_resumes_mid_run(tmp_path):
    """Cut at step 10 and resumed to 20 from the committed cut: the same
    losses and params as 20 steps in one run (the pipeline replays each
    step's batch)."""
    whole = train("jamba-1.5-large-398b", steps=12, batch=2, seq=16,
                  verbose=False, device=CPU)
    train("jamba-1.5-large-398b", steps=6, batch=2, seq=16,
          ckpt_dir=str(tmp_path / "ck"), ckpt_every=6, verbose=False,
          device=CPU)
    rest = train("jamba-1.5-large-398b", steps=12, batch=2, seq=16,
                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=6, verbose=False,
                 device=CPU)
    assert rest["losses"] == whole["losses"][6:]
    for pa, pb in zip(whole["params"].parameters(),
                      rest["params"].parameters()):
        assert torch.equal(pa, pb)
