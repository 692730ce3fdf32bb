"""End-to-end trainer: data pipeline -> train_step -> Mandator/Sporades
control plane -> checkpoints (port of ``repro.launch.train``). Runs on
CUDA unless ``device`` names another device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 200 --batch 8 --seq 64 --ckpt /tmp/ck
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint.checkpoint import (MandatorCheckpointer,
                                               load_state_tree, state_tree)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, batch_shard
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import CallConfig, init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.elastic import grad_scale, replan
from repro_torch.runtime.mandator_rt import MandatorRuntime
from repro_torch.runtime.sporades_rt import SporadesRuntime


def train(arch: str, *, reduced: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 64, n_pods: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          lr: float = 1e-3, log_every: int = 10, seed: int = 0,
          crash_pod_at: Optional[int] = None, verbose: bool = True,
          device=None):
    """Train ``arch`` for ``steps`` steps of ``n_pods`` pods (run one after
    another in-process), each step's cut committed through Sporades after
    Mandator disseminates it; checkpoints every ``ckpt_every`` steps when
    ``ckpt_dir`` is given, resuming from its newest committed cut. Returns
    {"losses": per step, "params", "opt_state", "commits": each
    controller's committed records, "step_seconds": each step's wall
    time (its losses read back)}."""
    dev = _device.resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", "train", seq, batch)
    call = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                      remat=False)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20)
    dcfg = DataConfig(seed=seed)

    params = init_params(cfg, seed, device=dev)
    opt_state = init_opt_state(opt_cfg, params)
    step_fn = make_train_step(cfg, call, opt_cfg)

    # control plane: one Mandator chain + Sporades commit per pod controller
    mand = MandatorRuntime(n_pods)
    spor = SporadesRuntime(n_pods, seed=seed)
    ck = MandatorCheckpointer(ckpt_dir, n_pods) if ckpt_dir else None

    start_step = 0
    if ck is not None:
        restored = ck.restore(state_tree(params, opt_state))
        if restored is not None:
            start_step, tree = restored
            params, opt_state = load_state_tree(tree, params, opt_state)
            if verbose:
                print(f"[restore] resumed at step {start_step}")

    live = list(range(n_pods))
    losses, seconds = [], []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        if crash_pod_at is not None and step == crash_pod_at and n_pods > 1:
            spor.crash(n_pods - 1)
            live = live[:-1]
            if verbose:
                print(f"[fault] pod {n_pods-1} crashed at step {step}; "
                      f"elastic replan to {len(live)} pods")
        plan = replan(step, live)
        # each live pod computes grads on its shard; here pods execute
        # one after another in-process (one step per pod shard)
        scale = grad_scale(len(live), n_pods)
        pod_metrics = []
        for pod in plan.pods:
            b = batch_shard(cfg, shape, dcfg, step, plan.shard_of[pod],
                            plan.n_shards, device=dev)
            params, opt_state, m = step_fn(params, opt_state, b)
            pod_metrics.append(m)
            mand.write(pod)                    # artifact round disseminated
        # commit the step cut (sync path; async under faults)
        cuts = {p: mand.get_client_requests(p) for p in plan.pods}
        rec = spor.commit_step(cuts)
        loss = float(np.mean([float(m["loss"]) for m in pod_metrics]))
        losses.append(loss)
        seconds.append(time.perf_counter() - t0)
        if verbose and (step % log_every == 0 or step == steps - 1):
            mode = rec.mode if rec else "none"
            print(f"step {step:4d} loss {loss:8.4f} "
                  f"gnorm {float(pod_metrics[0]['grad_norm']):7.3f} "
                  f"commit={mode} scale={scale:.2f}")
        if ck is not None and (step + 1) % ckpt_every == 0:
            tree = state_tree(params, opt_state)
            for pod in plan.pods:
                ck.write_shard(pod, step + 1, tree)
            ck.try_commit(step + 1, step + 1)
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "commits": [len(c.committed) for c in spor.ctl],
            "step_seconds": seconds}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, n_pods=args.pods,
                ckpt_dir=args.ckpt, lr=args.lr)
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f})")


if __name__ == "__main__":
    main()
