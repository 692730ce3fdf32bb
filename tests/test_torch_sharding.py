"""The port's sharding rules (``distributed/sharding.py``) against the
reference's (``repro.distributed.sharding``), leaf for leaf: every
parameter of the 10 configurations on the 16x16, 2x16x16 and 2x4 meshes
under the five policies, the optimizer's slots (int8 ``q`` and ``s``
included), and the batch and cache of every shape in ``SHAPES``; and
``configs.iter_cells``.

The reference builds ``NamedSharding``s, which need a mesh of real
devices: its specs come from a subprocess with 512 placeholder host
devices (as its dry run starts), which compiles nothing. The port's rules
read a ``MeshShape``. The reference stacks a super-block position's layers
(spec ``(None, *rest)``); the port's per-layer leaf (``convert``'s map)
must take ``rest``. The reference's caches are ``[R, B, ...]``, the
port's ``[B, ...]`` a layer.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import iter_cells as jax_iter_cells
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, iter_cells, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import cache_specs, input_specs
from repro_torch.launch.dryrun import _opt_shardings
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

REPO = Path(__file__).resolve().parents[1]
POLICIES = ("tp", "seqpar", "tp_gqa", "ep_data", "ep_seq")
MESHES = {"16x16": sh.MeshShape(("data", "model"), (16, 16)),
          "2x16x16": sh.MeshShape(("pod", "data", "model"), (2, 16, 16)),
          "2x4": sh.MeshShape(("data", "model"), (2, 4))}

REFERENCE = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from functools import partial
from repro.configs import SHAPES, get_config, list_archs
from repro.distributed.sharding import (batch_shardings, cache_shardings,
                                        param_shardings)
from repro.distributed.steps import cache_specs, input_specs
from repro.launch.dryrun import _opt_shardings
from repro.models import init_params
from repro.optim.adamw import AdamWConfig, init_opt_state

def norm(spec):
    return [[] if e is None else ([e] if isinstance(e, str) else list(e))
            for e in spec]

def path(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)

def flat(tree):
    return {path(p): norm(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}

meshes = {"16x16": jax.make_mesh((16, 16), ("data", "model")),
          "2x16x16": jax.make_mesh((2, 16, 16), ("pod", "data", "model")),
          "2x4": jax.make_mesh((2, 4), ("data", "model"))}
out = {}
for arch in list_archs():
    cfg = get_config(arch)
    ps = jax.eval_shape(partial(init_params, cfg, dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    opt = jax.eval_shape(partial(init_opt_state,
                                 AdamWConfig(quantized_state=True)), ps)
    for mname, mesh in meshes.items():
        for policy in ("tp", "seqpar", "tp_gqa", "ep_data", "ep_seq"):
            p_sh = param_shardings(cfg, mesh, ps, policy=policy)
            out[f"{arch}|{mname}|params|{policy}"] = flat(p_sh)
            if policy == "tp":
                out[f"{arch}|{mname}|opt"] = flat(
                    _opt_shardings(mesh, opt, p_sh))
        for sname, shape in SHAPES.items():
            b = input_specs(cfg, shape)
            out[f"{arch}|{mname}|batch|{sname}"] = flat(
                batch_shardings(cfg, shape, mesh, b))
            c = cache_specs(cfg, shape)
            out[f"{arch}|{mname}|cache|{sname}"] = flat(
                cache_shardings(cfg, shape, mesh, c))
print(json.dumps(out))
"""


def _norm(spec):
    return [list(sh._names(e)) for e in spec]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_params():
    """{arch: (parameter shapes by name, the AdamW state with int8
    moments)} at full size (fake tensors)."""
    out = {}
    with FakeTensorMode():
        for arch in list_archs():
            p = init_params(get_config(arch), 0, dtype=torch.bfloat16,
                            device="cpu")
            out[arch] = ({n: tuple(q.shape) for n, q in p.named_parameters()},
                         init_opt_state(AdamWConfig(quantized_state=True), p))
    return out


def _ref_key(name: str, period: int) -> str:
    path, _ = convert._ref_path(name, period)
    return "/".join(str(k) for k in path)


def _unstack(spec, stacked: bool):
    if stacked:
        assert spec[0] == [], spec
        return spec[1:]
    return spec


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_match_reference(reference, port_params, arch,
                                             mesh):
    cfg = get_config(arch)
    m = MESHES[mesh]
    shapes, state = port_params[arch]
    for policy in POLICIES:
        ref = reference[f"{arch}|{mesh}|params|{policy}"]
        got = sh.param_shardings(cfg, m, shapes, policy=policy)
        assert {_ref_key(n, cfg.block_period) for n in got} == set(ref)
        for n, s in got.items():
            key = _ref_key(n, cfg.block_period)
            want = _unstack(ref[key], key.startswith("blocks"))
            assert _norm(s.spec) == want, (policy, n, s.spec, want)
    # the AdamW slots (int8 where the reference's stacked leaf is large
    # enough): moments follow the params, int8 q too, s's last dim whole;
    # the step replicated
    got = _opt_shardings(m, state, sh.param_shardings(cfg, m, shapes))
    ref = reference[f"{arch}|{mesh}|opt"]
    assert _norm(got["step"].spec) == ref["step"] == []
    quantized = set()
    for k in ("m", "v"):
        for n, slot in got[k].items():
            key = f"{k}/" + _ref_key(n, cfg.block_period)
            stacked = key.split("/")[1] == "blocks"
            if isinstance(slot, dict):
                quantized.add(key)
                for part in ("q", "s"):
                    assert _norm(slot[part].spec) == _unstack(
                        ref[f"{key}/{part}"], stacked), (n, part)
            else:
                assert _norm(slot.spec) == _unstack(ref[key], stacked), n
    assert quantized == {k[:-2] for k in ref if k.endswith("/q")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_match_reference(reference, arch, mesh):
    cfg = get_config(arch)
    m = MESHES[mesh]
    for sname, shape in SHAPES.items():
        batch = input_specs(cfg, shape)
        got = sh.batch_shardings(cfg, shape, m, batch)
        ref = reference[f"{arch}|{mesh}|batch|{sname}"]
        assert {k: _norm(s.spec) for k, s in got.items()} == ref, sname
        cache = cache_specs(cfg, shape)
        got = sh.cache_shardings(cfg, shape, m, cache)
        ref = reference[f"{arch}|{mesh}|cache|{sname}"]
        for layer, specs in enumerate(got):
            r, i = divmod(layer, cfg.block_period)
            for k, s in specs.items():
                want = ref[f"{i}/{k}"]
                assert want[0] == [], want
                assert _norm(s.spec) == want[1:], (sname, layer, k)
        assert len(got) == cfg.n_layers


def test_iter_cells_matches_reference():
    got = [(c.name, s.name, ok) for c, s, ok in iter_cells()]
    want = [(c.name, s.name, ok) for c, s, ok in jax_iter_cells()]
    assert got == want and len(got) == 40


def test_placements_of_a_spec():
    """A spec's DTensor placements: a dim over ("pod", "data") is Shard on
    both mesh dims; axes out of the mesh's order raise."""
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert sh.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((None,), m) == (Replicate(),) * 3
    assert sh.local_shape((64, 8, 32), (("pod", "data"), None, "model"),
                          m) == (2, 8, 2)
    with pytest.raises(ValueError, match="order"):
        sh.placements((("data", "pod"),), m)
    assert np.prod(m.shape) == 512


def test_constrain_activations_passes_plain_tensors():
    """As the reference's with no mesh: a plain tensor, or no mesh, gives
    the input back."""
    x = torch.zeros(8, 4, 2)
    assert sh.constrain_activations(x, None) is x
    assert sh.constrain_activations(x, MESHES["2x4"]) is x
    assert sh.batch_axes(MESHES["2x16x16"]) == ("pod", "data")
    assert sh.batch_axes(MESHES["2x4"]) == ("data",)
