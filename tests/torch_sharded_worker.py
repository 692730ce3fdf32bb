"""One rank of the port's sharded steps on a gloo (2, 4) ("data", "model")
mesh, for ``test_torch_sharded_step.py``.

    python torch_sharded_worker.py RANK WORLD STORE_FILE IN.pkl OUT.pkl

IN.pkl (written by the test) holds the reference's parameters and inputs
as numpy; rank 0 writes OUT.pkl with the whole (gathered) results:

- ``train``: one ``make_train_step`` of reduced qwen3-14b with parameters,
  AdamW state and batch placed by ``param_shardings``, ``_opt_shardings``
  and ``batch_shardings`` (f32, dense attention, no remat);
- ``prefill``, ``decode``: the same parameters (fresh) with
  ``batch_axes=("data",)`` and ``seq_axis="model"``: the prompt's logits,
  then every decode step's logits and greedy token against a KV cache
  placed by ``cache_shardings`` (batch over data, S over model);
- ``moe``: reduced dbrx-132b's logits with ``moe_ep_axis="model"``;
- ``prefill_kernels``: the prefill through the kernel routes
  (``attention_impl="pallas"``, ``use_pallas_norm``), their plain versions
  here, run on local shards by ``local_map``;
- ``hybrid``, ``hybrid_train``: reduced jamba's logits (Mamba, attention,
  MoE) and one train step;
- ``ssm_scan_equal``: the scan's wrapper on channel-sharded DTensors
  equals the plain call bit for bit.

Each rank runs on one CPU thread. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys

import torch
import torch.distributed as dist


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def main(rank: int, world: int, store: str, path_in: str,
         path_out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.steps import greedy, make_train_step
    from repro_torch.launch.dryrun import _opt_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import (CallConfig, forward_decode,
                                    forward_train, init_cache)
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    with open(path_in, "rb") as f:
        job = pickle.load(f)
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    out = {}

    def params(arch, tree):
        cfg = get_config(arch).reduced()
        p = convert.model_params_from_reference(tree, cfg, device="cpu")
        return cfg, p

    def batch(tree, shape, cfg):
        b = {k: torch.from_numpy(v) for k, v in tree.items()}
        return sh.place_tree(b, sh.batch_shardings(cfg, shape, mesh, b))

    # one train step, everything placed by the rules
    cfg, p = params("qwen3-14b", job["qwen_params"])
    shape = ShapeConfig("t", "train", 32, 8)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    state = init_opt_state(opt, p)
    p_sh = sh.param_shardings(cfg, mesh, p)
    sh.place_params(p, p_sh)
    state = sh.place_tree(state, _opt_shardings(mesh, state, p_sh))
    call = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                      remat=False)
    p, state, m = make_train_step(cfg, call, opt)(
        p, state, batch(job["train_batch"], shape, cfg))
    out["train"] = {"loss": float(_full(m["loss"])),
                    "params": {n: _full(q.detach()).numpy()
                               for n, q in p.named_parameters()},
                    "placements": {n: str(q.placements)
                                   for n, q in p.named_parameters()}}

    # prefill and decode, sequence-parallel activations, SP KV cache
    cfg, p = params("qwen3-14b", job["qwen_params"])
    sh.place_params(p, sh.param_shardings(cfg, mesh, p))
    sp = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                    remat=False, batch_axes=("data",), seq_axis="model")
    prompt = job["prompt"]
    bsz, plen = prompt.shape
    pshape = ShapeConfig("p", "prefill", plen, bsz)
    with torch.no_grad():
        logits, _ = forward_train(p, cfg, sp, batch({"tokens": prompt},
                                                    pshape, cfg))
    out["prefill"] = _full(logits).numpy()
    dshape = ShapeConfig("d", "decode", job["max_seq"], bsz)
    cache = init_cache(cfg, bsz, job["max_seq"], torch.float32, "cpu")
    cache = sh.place_tree(cache, sh.cache_shardings(cfg, dshape, mesh,
                                                    cache))
    steps, toks = [], []
    tok = torch.from_numpy(prompt[:, 0])
    for pos in range(job["max_seq"]):
        tb = batch({"tokens": tok.numpy()}, dshape, cfg)
        logits, cache = forward_decode(p, cfg, sp, tb, cache, pos)
        steps.append(_full(logits).numpy())
        nxt = _full(greedy(logits))
        toks.append(nxt.numpy())
        tok = (torch.from_numpy(prompt[:, pos + 1]) if pos + 1 < plen
               else nxt)
    out["decode"] = {"logits": steps, "tokens": toks,
                     "cache_k": str(cache[0]["k"].placements)}

    # MoE with expert parallelism over "model"
    cfg, p = params("dbrx-132b", job["moe_params"])
    sh.place_params(p, sh.param_shardings(cfg, mesh, p))
    ep = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                    remat=False, batch_axes=("data",), moe_ep_axis="model",
                    moe_group_size=job["moe_group"])
    with torch.no_grad():
        logits, _ = forward_train(p, cfg, ep, batch(
            {"tokens": job["moe_tokens"]},
            ShapeConfig("p", "prefill", job["moe_tokens"].shape[1],
                        job["moe_tokens"].shape[0]), cfg))
    out["moe"] = {"logits": _full(logits).numpy(),
                  "tokens": _full(greedy(logits[:, -1])).numpy()}

    # the kernel routes' local_map (their plain versions on the CPU): the
    # prefill with attention_impl="pallas" and use_pallas_norm
    cfg, p = params("qwen3-14b", job["qwen_params"])
    sh.place_params(p, sh.param_shardings(cfg, mesh, p))
    kern = CallConfig(compute_dtype=torch.float32, attention_impl="pallas",
                      use_pallas_norm=True, remat=False,
                      batch_axes=("data",))
    with torch.no_grad():
        logits, _ = forward_train(p, cfg, kern, batch({"tokens": prompt},
                                                      pshape, cfg))
    out["prefill_kernels"] = _full(logits).numpy()

    # the hybrid (Mamba, attention, MoE) with batch-sharded activations
    cfg, p = params("jamba-1.5-large-398b", job["hybrid_params"])
    sh.place_params(p, sh.param_shardings(cfg, mesh, p))
    hy = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                    remat=False, batch_axes=("data",),
                    moe_group_size=job["moe_group"])
    toks = job["moe_tokens"]
    with torch.no_grad():
        logits, _ = forward_train(p, cfg, hy, batch(
            {"tokens": toks},
            ShapeConfig("p", "prefill", toks.shape[1], toks.shape[0]), cfg))
    out["hybrid"] = _full(logits).numpy()
    # and one of its train steps (gradients through every local map)
    cfg, p = params("jamba-1.5-large-398b", job["hybrid_params"])
    state = init_opt_state(opt, p)
    p_sh = sh.param_shardings(cfg, mesh, p)
    sh.place_params(p, p_sh)
    state = sh.place_tree(state, _opt_shardings(mesh, state, p_sh))
    hshape = ShapeConfig("t", "train", 32, 8)
    p, state, m = make_train_step(cfg, dataclasses.replace(
        call, moe_group_size=job["moe_group"]), opt)(
        p, state, batch(job["hybrid_batch"], hshape, cfg))
    out["hybrid_train"] = {"loss": float(_full(m["loss"])),
                           "params": {n: _full(q.detach()).numpy()
                                      for n, q in p.named_parameters()}}

    # the scan's wrapper on channel-sharded DTensors against the plain call
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    g = torch.Generator().manual_seed(0)
    bt, s_, di, n = 2, 16, 8, 4
    raw = (torch.randn(bt, s_, di, generator=g),
           torch.rand(bt, s_, di, generator=g) * 0.1,
           torch.randn(bt, s_, n, generator=g),
           torch.randn(bt, s_, n, generator=g),
           -torch.rand(di, n, generator=g) - 0.5,
           torch.randn(di, generator=g))
    pl = ((Shard(0), Shard(2)),) * 2 + ((Shard(0), Replicate()),) * 2 + (
        (Replicate(), Shard(0)),) * 2
    d_in = [distribute_tensor(t, mesh, q, src_data_rank=None)
            for t, q in zip(raw, pl)]
    out["ssm_scan_equal"] = bool(torch.equal(
        _full(ssm_ops.ssm_scan(*d_in)), ssm_ops.ssm_scan(*raw)))

    if rank == 0:
        with open(path_out, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
