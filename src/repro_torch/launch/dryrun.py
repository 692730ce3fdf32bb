"""Multi-pod dry run (port of ``repro.launch.dryrun``): one train, prefill
or decode step of each (arch x shape x mesh) cell on the production mesh's
256 or 512 placeholder devices, with per-device memory, the step's cost
and its roofline terms on an H100. It shows that the sharding rules are
coherent for every cell without the cards: a failure is a bug of the
port.

The reference lowers and compiles each cell on XLA placeholder devices.
The port has no compiler to ask, so it runs the step itself, once, on
stand-ins: a ``fake`` process group of 256 or 512 ranks (this process is
rank 0, and every collective returns without moving data), parameters
(drawn under ``FakeTensorMode``), optimizer state, batch and cache held
as ``meta`` tensors (shapes, no memory; an op on them runs only its shape
function) and placed as DTensors by ``distributed/sharding.py``. What rank
0 runs on its shards is recorded by ``graph_analysis.record_cost``
(FLOPs, HBM bytes, collectives); the per-device argument and output bytes
are the local shards' sizes; the peak of live bytes is the recorder's
(arguments held from the start, every op's new storages until they are
freed, exact sizes without the allocator's rounding).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh single|multi|both] --out DIR
Writes DIR/<arch>__<shape>__<mesh>.json and nothing else; exits non-zero
when a cell fails. The mesh is the card's device type unless ``--device
cpu``; the stand-ins allocate nothing on either.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.configs import SHAPES, get_config, iter_cells, param_count
from repro_torch.distributed import graph_analysis
from repro_torch.distributed.sharding import (
    NamedSharding, batch_shardings, cache_shardings, param_shardings,
    place_params, place_tree)
from repro_torch.distributed.steps import (cache_specs, input_specs,
                                           make_prefill_step,
                                           make_serve_step, make_train_step)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import CallConfig, init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

QUANTIZED_STATE_THRESHOLD = 100e9   # int8 moments for >=100B-param archs
HBM_CAPACITY = 80e9                 # H100 SXM device memory (data sheet)
ALLOC_ROUND = 512                   # the CUDA caching allocator's block


def _opt_shardings(mesh, opt_state: Dict, p_shardings: Dict) -> Dict:
    """Moments follow the param sharding exactly; quantized slots keep the
    param's spec (q) and the row scales' last dim whole (s), so nothing
    regathers. The step is replicated."""

    def slot(name, leaf):
        sh = p_shardings[name]
        if not isinstance(leaf, dict):
            return sh
        return {"q": sh, "s": NamedSharding(mesh, sh.spec[:-1] + (None,))}

    return {"step": NamedSharding(mesh, ()),
            **{k: {n: slot(n, v) for n, v in opt_state[k].items()}
               for k in ("m", "v")}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_nbytes(t: torch.Tensor) -> int:
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.numel() * t.element_size()


def local_bytes(*trees) -> Tuple[int, int]:
    """(bytes, bytes as the CUDA caching allocator holds them: each
    tensor rounded up to its 512-byte block) of this device's shards of
    every tensor in ``trees``."""
    sizes = [_local_nbytes(t) for tree in trees for t in _leaves(tree)]
    return sum(sizes), sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND
                           for n in sizes)


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks (this process rank 0) for
    the body; an already started fake group of ``n`` ranks is reused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(f"the dry run needs a fake process group of "
                               f"{n} ranks; one of {dist.get_world_size()} "
                               f"({dist.get_backend()}) is running")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_like(tree):
    """A meta tensor of each stand-in's shape and dtype (the stand-ins of
    ``input_specs`` / ``cache_specs`` are meta already; this makes them
    the dry run's own)."""
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_like(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _analyze(ops, n_devices: int, active_params: int, tokens: int,
             dtype: torch.dtype) -> Dict:
    mc = graph_analysis.module_cost(ops)
    flops = float(mc["flops"])
    byt = float(mc["bytes"])
    coll_bytes = float(mc["collective_bytes"])
    terms = graph_analysis.roofline_terms(flops, byt, coll_bytes, dtype)
    model_flops = 6.0 * active_params * tokens
    by_op: Dict[str, float] = {}
    for op in ops:
        if op.flops:
            by_op[op.name] = by_op.get(op.name, 0.0) + op.flops
    return {"devices": n_devices, "flops_per_device": flops,
            "flops_by_op": by_op,
            "bytes_per_device": byt,
            "collective_bytes_per_device": coll_bytes,
            "collectives": mc["collectives"], "ops": len(ops),
            "model_flops_total": model_flops,
            "model_flops_per_device": model_flops / n_devices,
            "useful_flop_ratio": ((model_flops / n_devices) / flops
                                  if flops else 0.0),
            **terms}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             call: Optional[CallConfig] = None, verbose: bool = True,
             policy: str = "tp", *, device=None,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             reduced: bool = False, shape=None) -> Dict:
    """Dry-run one cell. ``mesh_shape`` (a ("data", "model") shape) and
    ``reduced`` (the config's ``reduced()``) and ``shape`` (a
    ``ShapeConfig`` in place of ``SHAPES[shape_name]``) cut a cell to a
    test's size; ``device`` is where the stand-ins live (None: the card,
    raising without one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device.resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = shape or SHAPES[shape_name]
    call = call or CallConfig(compute_dtype=torch.bfloat16,
                              attention_impl="chunked", remat=True)
    dtype = call.compute_dtype
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    n_dev = math.prod(mesh_shape)
    n_params = param_count(cfg)
    n_active = param_count(cfg, active_only=True)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_world(n_dev))
        if mesh_shape in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        device_type=dev.type)
        else:
            mesh = init_device_mesh(dev.type, mesh_shape,
                                    mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            params = init_params(cfg, 0, dtype=dtype, device=dev)
        for name, p in list(params.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(mod_name) if mod_name else params,
                    leaf, torch.nn.Parameter(_meta_like(p)))
        p_sh = param_shardings(cfg, mesh, params, policy=policy)
        if shape.kind == "train":
            # the moments as the reference's eval_shape sees them, placed
            # by _opt_shardings below
            opt = AdamWConfig(
                quantized_state=(n_params >= QUANTIZED_STATE_THRESHOLD))
            state = init_opt_state(opt, params)
        place_params(params, p_sh)
        batch = _meta_like(input_specs(cfg, shape, dtype))
        batch = place_tree(batch, batch_shardings(cfg, shape, mesh, batch))
        if shape.kind == "train":
            state = place_tree(state, _opt_shardings(mesh, state, p_sh))
            step = make_train_step(cfg, call, opt)
            args, tracked = (params, state, batch), (params, state, batch)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg, call)
            args, tracked = (params, batch), (params, batch)
            tokens = shape.global_batch * shape.seq_len // 3  # fwd: 2ND
        else:
            cache = _meta_like(cache_specs(cfg, shape, dtype))
            cache = place_tree(cache, cache_shardings(cfg, shape, mesh,
                                                      cache))
            step = make_serve_step(cfg, call)
            # one token written at the last slot, against the whole cache
            args = (params, cache, batch, shape.seq_len - 1)
            tracked = (params, cache, batch)
            tokens = shape.global_batch // 3   # one token, fwd only
        arg_bytes, arg_alloc = local_bytes(
            dict(params.named_parameters()), *args[1:])

        out, ops, peak = graph_analysis.record_cost(step, *args,
                                                    live=tracked)
        out_bytes, _ = local_bytes(dict(params.named_parameters())
                                   if shape.kind == "train" else {}, out)
    rec = _analyze(ops, n_dev, n_active, max(tokens, 1), dtype)
    rec.update(arch=cfg.name, shape=shape.name,
               mesh="x".join(map(str, mesh_shape)), policy=policy,
               device=dev.type, seconds=time.perf_counter() - t0,
               params_total=n_params, params_active=n_active,
               memory={"argument_bytes": arg_bytes,
                       "argument_alloc_bytes": arg_alloc,
                       "output_bytes": out_bytes, "peak_bytes": peak},
               fits_h100_80gb=peak <= HBM_CAPACITY)
    if verbose:
        print(f"== {cfg.name} x {shape.name} x {rec['mesh']} ==")
        print(f"  args {arg_bytes} B, outputs {out_bytes} B, peak {peak} B "
              f"a device; compute={rec['compute_s'] * 1e3:.3f}ms "
              f"memory={rec['memory_s'] * 1e3:.3f}ms "
              f"collective={rec['collective_s'] * 1e3:.3f}ms "
              f"dominant={rec['dominant']} "
              f"useful_flops={rec['useful_flop_ratio']:.2f} "
              f"fits 80GB={rec['fits_h100_80gb']} "
              f"[{rec['seconds']:.1f} s]", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attention", default="chunked",
                    choices=["dense", "chunked"])
    ap.add_argument("--policy", default="tp",
                    choices=["tp", "seqpar", "tp_gqa", "ep_data", "ep_seq"])
    ap.add_argument("--moe-group", type=int, default=1024)
    ap.add_argument("--seq-axis", default=None)
    ap.add_argument("--gqa-expand", action="store_true")
    ap.add_argument("--moe-ep-axis", default=None)
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="device type of the stand-ins (default: cuda)")
    ap.add_argument("--tag", default="",
                    help="artifact suffix (hillclimb variants)")
    ap.add_argument("--out", required=True,
                    help="directory the cells' JSON records go to")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    call = CallConfig(compute_dtype=torch.bfloat16,
                      attention_impl=args.attention, remat=True,
                      attn_chunk=args.attn_chunk,
                      batch_axes=("pod", "data") if args.mesh == "multi"
                      else ("data",),
                      seq_axis=args.seq_axis,
                      gqa_expand_kv=args.gqa_expand,
                      moe_ep_axis=args.moe_ep_axis,
                      moe_group_size=args.moe_group)

    if args.all:
        cells = [(cfg.name, shape.name, ok) for cfg, shape, ok in iter_cells()]
    else:
        cfg = get_config(args.arch)
        ok = SHAPES[args.shape].name != "long_500k" or cfg.sub_quadratic
        cells = [(args.arch, args.shape, ok)]

    n_fail = 0
    for arch, shape_name, ok in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
            if args.tag:
                tag += f"__{args.tag}"
            path = out / f"{tag}.json"
            if not ok:
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if mp else "single",
                       "skipped": "full-attention arch; long_500k requires "
                                  "sub-quadratic support"}
                path.write_text(json.dumps(rec, indent=1))
                print(f"-- skip {tag}")
                continue
            try:
                rec = run_cell(arch, shape_name, mp, call=call,
                               policy=args.policy, device=args.device)
                path.write_text(json.dumps(rec, indent=1, default=str))
            except Exception as e:  # noqa: BLE001 — report and continue
                n_fail += 1
                print(f"!! FAIL {tag}: {e}")
                traceback.print_exc()
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run cells failed")


if __name__ == "__main__":
    main()
