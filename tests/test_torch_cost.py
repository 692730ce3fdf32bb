"""The dry run's cost model (``distributed/graph_analysis.py``:
``record_cost``, ``module_cost``, ``collective_stats``, ``roofline_terms``)
and ``launch/dryrun.run_cell``, against exact counts and against the
reference's ``hlo_analysis.module_cost`` of the same step.

The collective fixture is the reference's (``tests/test_hlo_analysis.py``):
an all-reduce of f32[16, 128] and an all-gather to [32, 128] count 8192
and 16384 bytes. Process groups here are ``fake`` (no data moves) and are
torn down after each test.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.distributed import hlo_analysis
from repro.distributed.steps import make_prefill_step as jax_prefill
from repro.distributed.steps import make_serve_step as jax_serve
from repro.distributed.steps import make_train_step as jax_train
from repro.models import CallConfig as JaxCall
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_opt_state as jax_init_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import graph_analysis as ga
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import cache_specs, input_specs
from repro_torch.launch import dryrun
from repro_torch.models import CallConfig, init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

CALL = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                  remat=False)
SHAPES = {"train": ShapeConfig("t", "train", 32, 8),
          "prefill": ShapeConfig("p", "prefill", 32, 8),
          "decode": ShapeConfig("d", "decode", 32, 8)}
FLOPS_REL = 0.05


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    yield
    dist.destroy_process_group()


def test_matmul_loop_flops_exact():
    """A 10-iteration loop of 256x256 f32 products: every iteration
    counted (eager runs each one), 10 * 2 * 256^3 FLOPs."""
    a, b = torch.randn(256, 256), torch.randn(256, 256)

    def loop():
        for _ in range(10):
            c = a @ b
        return c

    _, ops, _ = ga.record_cost(loop)
    mc = ga.module_cost(ops)
    assert mc["flops"] == 10 * 2 * 256 ** 3
    assert mc["collective_bytes"] == 0


def test_collective_fixture_bytes(fake_group):
    """The reference fixture's counts: all_reduce f32[16, 128] = 8192 B,
    all_gather to [32, 128] = 16384 B; only the collectives count."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))

    def step():
        x = torch.ones(16, 128)
        r = funcol.all_reduce(x, "sum", mesh)
        g = funcol.all_gather_tensor(x, 0, mesh)
        return funcol.wait_tensor(r), funcol.wait_tensor(g)

    (r, g), ops, _ = ga.record_cost(step)
    assert tuple(g.shape) == (32, 128)
    stats = ga.collective_stats(ops)
    assert stats["all_reduce"] == {"count": 1.0, "bytes": 8192.0}
    assert stats["all_gather_into_tensor"] == {"count": 1.0,
                                               "bytes": 16384.0}
    assert stats["reduce_scatter_tensor"]["count"] == 0
    mc = ga.module_cost(ops)
    assert mc["collective_bytes"] == 8192 + 16384


def test_peak_live_bytes():
    """The peak counts the held arguments and each new storage until it
    is freed, once however many views it has."""
    held = torch.zeros(250)                                  # 1000 B

    def step():
        a = torch.empty(1000)                                # 4000 B
        v = a[10:]                                           # a view
        b = torch.empty(2000)                                # 8000 B
        del a, v
        c = torch.empty(500)                                 # 2000 B
        return b, c

    _, _, peak = ga.record_cost(step, live=[held])
    assert peak == 1000 + 4000 + 8000


def test_roofline_terms_h100():
    """The H100 data sheet's peaks: bf16 989e12 FLOP/s, f32 67e12, HBM
    3.35e12 B/s; the interconnect 50e9 B/s (one 400 Gb/s NIC a GPU)."""
    t = ga.roofline_terms(989e12, 3.35e12, 50e9)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    t = ga.roofline_terms(67e12, 3.35e11, 5e9, torch.float32)
    assert t["dominant"] == "compute" and t["bound_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.1)
    assert t["compute_fraction"] == pytest.approx(1.0)
    assert ga.roofline_terms(0, 0, 0)["compute_fraction"] == 0.0


def _expected_arg_bytes(cfg, shape, mesh):
    """This device's shard bytes of params (+ AdamW state, batch, cache),
    from the specs alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def local(shape_, spec, itemsize):
        return math.prod(sh.local_shape(shape_, spec, mesh)) * itemsize

    with FakeTensorMode():
        params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
        state = init_opt_state(AdamWConfig(), params)
    p_sh = sh.param_shardings(cfg, mesh, params)
    total = sum(local(p.shape, p_sh[n].spec, 4)
                for n, p in params.named_parameters())
    batch = input_specs(cfg, shape, torch.float32)
    b_sh = sh.batch_shardings(cfg, shape, mesh, batch)
    total += sum(local(v.shape, b_sh[k].spec, v.element_size())
                 for k, v in batch.items())
    if shape.kind == "train":
        o_sh = dryrun._opt_shardings(mesh, state, p_sh)
        total += 4 + sum(local(v.shape, o_sh[k][n].spec, 4)
                         for k in ("m", "v") for n, v in state[k].items())
    if shape.kind == "decode":
        cache = cache_specs(cfg, shape, torch.float32)
        c_sh = sh.cache_shardings(cfg, shape, mesh, cache)
        total += sum(local(v.shape, c_sh[i][k].spec, v.element_size())
                     for i, layer in enumerate(cache)
                     for k, v in layer.items())
    return total


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_argument_bytes_on_fake_mesh(kind):
    """One reduced cell per kind on a fake 2x4 mesh: the record's
    per-device argument bytes equal the local shards' sizes computed from
    the specs; costs and terms are filled in."""
    shape = SHAPES[kind]
    rec = dryrun.run_cell("qwen3-14b", shape.name, call=CALL, device="cpu",
                          mesh_shape=(2, 4), reduced=True, shape=shape,
                          verbose=False)
    cfg = get_config("qwen3-14b").reduced()
    want = _expected_arg_bytes(cfg, shape, sh.MeshShape(("data", "model"),
                                                        (2, 4)))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["fits_h100_80gb"] is True
    assert not dist.is_initialized()


def _reference_flops(kind):
    """The reference's hlo_analysis.module_cost FLOPs of the same step,
    single device, jitted."""
    jcfg = jax_get_config("qwen3-14b").reduced()
    call = JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                   remat=False)
    shape = SHAPES[kind]
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        opt = JaxAdamW()
        batch = {"tokens": jnp.zeros((b, s), jnp.int32),
                 "labels": jnp.zeros((b, s), jnp.int32)}
        lowered = jax.jit(jax_train(jcfg, call, opt)).lower(
            params, jax_init_opt(opt, params), batch)
    elif kind == "prefill":
        lowered = jax.jit(jax_prefill(jcfg, call)).lower(
            params, {"tokens": jnp.zeros((b, s), jnp.int32)})
    else:
        cache = jax_init_cache(jcfg, b, s, jnp.float32)
        lowered = jax.jit(jax_serve(jcfg, call)).lower(
            params, cache, {"tokens": jnp.zeros((b,), jnp.int32)},
            jnp.int32(s - 1))
    return hlo_analysis.module_cost(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_flops_match_reference_single_device(kind):
    """On a 1x1 mesh the dry run's FLOPs are within 5% of the reference's
    module_cost of the same single-device jitted step; a miss names the
    port's ops and their FLOPs."""
    shape = SHAPES[kind]
    rec = dryrun.run_cell("qwen3-14b", shape.name, call=CALL, device="cpu",
                          mesh_shape=(1, 1), reduced=True, shape=shape,
                          verbose=False)
    want = _reference_flops(kind)
    got = rec["flops_per_device"]
    by_op = rec["flops_by_op"]
    assert abs(got - want) <= FLOPS_REL * want, (got, want, by_op)
    assert rec["collective_bytes_per_device"] == 0
    print(f"{kind}: port {got!r} FLOPs, reference {want!r} "
          f"({got / want - 1:+.4f}); by op {by_op}")
    assert np.isfinite(rec["memory_s"])
