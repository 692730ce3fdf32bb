"""The port's sharded steps on 8 gloo ranks, mesh (2, 4) ("data", "model"),
against the reference's single-device steps (the reference's own sharded
test, ``tests/test_system.py::test_sharded_step_matches_single_device``,
fails under this JAX at its sharded embedding gather; ROADMAP Queue C).

Setup as the reference test's: reduced qwen3-14b, ``ShapeConfig("t",
"train", 32, 8)``, f32, dense attention, ``remat=False``, AdamW lr 1e-3
with one warm-up step, the reference's ``init_params(PRNGKey(0))`` and
``global_batch(..., 0)`` carried across by ``convert``. Then prefill and
decode with ``batch_axes=("data",)`` and ``seq_axis="model"`` (the KV cache
S-sharded over "model"), and reduced dbrx-132b with ``moe_ep_axis=
"model"``; the kernel routes and the hybrid under the mesh. The ranks
are separate processes (``torch_sharded_worker.py``),
one CPU thread each, meeting through a file store.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import DataConfig, global_batch
from repro.distributed.steps import make_train_step
from repro.models import CallConfig as JaxCall
from repro.models import forward_decode, forward_train, init_cache
from repro.models import init_params
from repro.optim.adamw import AdamWConfig, init_opt_state

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WORLD = 8
TOL_STEP = 5e-4          # the reference test's own bound
TOL_LOGITS = 1e-4
B, PROMPT, MAX_SEQ = 4, 8, 16
MOE_GROUP = 16           # 4 x 16 tokens: 4 groups, split over "data"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the workers' results, the reference's) for every case."""
    tmp = tmp_path_factory.mktemp("sharded")
    jcfg = jax_get_config("qwen3-14b").reduced()
    call = JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                   remat=False)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    batch = global_batch(jcfg, JaxShape("t", "train", 32, 8), DataConfig(),
                         0)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    mcfg = jax_get_config("dbrx-132b").reduced()
    mparams = init_params(mcfg, jax.random.PRNGKey(1))
    mtok = rs.randint(0, mcfg.vocab, (B, 16)).astype(np.int32)
    hcfg = jax_get_config("jamba-1.5-large-398b").reduced()
    hparams = init_params(hcfg, jax.random.PRNGKey(2))
    hbatch = global_batch(hcfg, JaxShape("t", "train", 32, 8), DataConfig(),
                          0)
    job = {"qwen_params": _np(params), "train_batch": _np(batch),
           "hybrid_params": _np(hparams), "hybrid_batch": _np(hbatch),
           "prompt": prompt, "max_seq": MAX_SEQ, "moe_params": _np(mparams),
           "moe_tokens": mtok, "moe_group": MOE_GROUP}
    path_in, path_out = tmp / "in.pkl", tmp / "out.pkl"
    with open(path_in, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_worker.py"), str(r),
         str(WORLD), str(tmp / "store"), str(path_in), str(path_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    with open(path_out, "rb") as f:
        got = pickle.load(f)

    # the reference, single device
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    p1, _, m1 = jax.jit(make_train_step(jcfg, call, opt))(
        params, init_opt_state(opt, params), batch)
    want = {"train": {"loss": float(m1["loss"]), "params": _np(p1)}}
    want["prefill"] = np.asarray(forward_train(
        params, jcfg, call, {"tokens": jnp.asarray(prompt)})[0])
    step = jax.jit(lambda c, t, pos: forward_decode(
        params, jcfg, call, {"tokens": t}, c, pos))
    cache = init_cache(jcfg, B, MAX_SEQ, jnp.float32)
    logits, toks, tok = [], [], prompt[:, 0]
    for pos in range(MAX_SEQ):
        lg, cache = step(cache, jnp.asarray(tok), jnp.int32(pos))
        logits.append(np.asarray(lg))
        toks.append(np.argmax(logits[-1], axis=-1).astype(np.int32))
        tok = prompt[:, pos + 1] if pos + 1 < PROMPT else toks[-1]
    want["decode"] = {"logits": logits, "tokens": toks}
    mcall = JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                    remat=False, moe_group_size=MOE_GROUP)
    ml = np.asarray(forward_train(mparams, mcfg, mcall,
                                  {"tokens": jnp.asarray(mtok)})[0])
    want["hybrid"] = np.asarray(forward_train(
        hparams, hcfg, mcall, {"tokens": jnp.asarray(mtok)})[0])
    hp, _, hm = jax.jit(make_train_step(hcfg, JaxCall(
        compute_dtype=jnp.float32, attention_impl="dense", remat=False,
        moe_group_size=MOE_GROUP), opt))(
        hparams, init_opt_state(opt, hparams), hbatch)
    want["hybrid_train"] = {"loss": float(hm["loss"]), "params": _np(hp)}
    want["moe"] = {"logits": ml,
                   "tokens": np.argmax(ml[:, -1], axis=-1).astype(np.int32)}
    return got, want


def _step_errors(arch, got, want):
    """(the largest parameter difference, its name, the loss's)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    ref = convert._state_from_reference(want["params"], cfg.block_period)
    errs = {n: float(np.max(np.abs(v - ref[n].numpy())))
            for n, v in got["params"].items()}
    assert set(errs) == set(ref)
    worst = max(errs, key=errs.get)
    return errs[worst], worst, abs(got["loss"] - want["loss"])


@pytest.mark.parametrize("arch,key", [("qwen3-14b", "train"),
                                      ("jamba-1.5-large-398b",
                                       "hybrid_train")])
def test_sharded_train_step_matches_single_device_reference(runs, arch,
                                                            key):
    """One train step on the (2, 4) mesh vs the reference's single-device
    step: every parameter and the loss within 5e-4 (the reference test's
    bound). qwen3-14b is the reference test's setup; reduced jamba takes
    the gradients through the Mamba mixer's tensor-parallel local maps
    and MoE's routing, experts and combine."""
    got, want = runs
    err, worst, loss_err = _step_errors(arch, got[key], want[key])
    print(f"{arch} sharded vs single-device reference: params max abs "
          f"{err!r} ({worst}), loss {loss_err!r}")
    assert err < TOL_STEP, worst
    assert loss_err < TOL_STEP
    if key == "train":
        # the step kept the rules' placements: TP over "model" on wq's
        # columns
        assert got["train"]["placements"]["layers.0.mixer.wq"] == \
            "(Replicate(), Shard(dim=1))"


def test_sequence_parallel_prefill_and_decode(runs):
    """seq_axis="model", batch over "data": the prompt's logits and every
    decode step's (S-sharded KV cache) within 1e-4 of the reference's,
    the greedy tokens equal."""
    got, want = runs
    err = float(np.max(np.abs(got["prefill"] - want["prefill"])))
    dec = [float(np.max(np.abs(a - b))) for a, b in
           zip(got["decode"]["logits"], want["decode"]["logits"])]
    print(f"prefill logits max abs {err!r}; decode steps {max(dec)!r}")
    assert err < TOL_LOGITS
    assert len(dec) == MAX_SEQ and max(dec) < TOL_LOGITS
    for a, b in zip(got["decode"]["tokens"], want["decode"]["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert "Shard(dim=1)" in got["decode"]["cache_k"]


def test_expert_parallel_moe(runs):
    """moe_ep_axis="model": reduced dbrx's logits within 1e-4 of the
    reference's, the greedy tokens equal."""
    got, want = runs
    err = float(np.max(np.abs(got["moe"]["logits"] - want["moe"]["logits"])))
    print(f"EP MoE logits max abs {err!r}")
    assert err < TOL_LOGITS
    np.testing.assert_array_equal(got["moe"]["tokens"], want["moe"]["tokens"])


def test_kernel_routes_and_hybrid_under_the_mesh(runs):
    """The kernel routes run on local shards (``local_map``; their plain
    versions on the CPU): the pallas + RMSNorm-kernel prefill within 1e-4
    of the reference's; reduced jamba (Mamba, attention, MoE) batch-sharded
    within 1e-4; the scan's wrapper on channel-sharded inputs bit for bit
    the plain call."""
    got, want = runs
    err = float(np.max(np.abs(got["prefill_kernels"] - want["prefill"])))
    herr = float(np.max(np.abs(got["hybrid"] - want["hybrid"])))
    print(f"kernel-route prefill max abs {err!r}; hybrid {herr!r}")
    assert err < TOL_LOGITS
    assert herr < TOL_LOGITS
    assert got["ssm_scan_equal"]
