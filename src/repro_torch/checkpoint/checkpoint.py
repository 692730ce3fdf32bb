"""Sharded checkpointing with Mandator-style asynchronous commit (port of
``repro.checkpoint.checkpoint``).

Data plane: each controller streams its parameter/optimizer shards to
storage ahead of any commit decision (write(B) of Algorithm 1: shard round
files are the Mandator batches). Control plane: a checkpoint version is a
vector-clock cut over controller shard rounds; the small
``commit-<v>.json`` manifest is written only once n-f controllers' shard
writes are durable. Restore picks the highest committed cut, so a torn
checkpoint (some shards newer) is never restored.

The layout on disk is the reference's: ``c<k>/v<n>/<tag>.npz`` with one
array a leaf under its '/'-joined key path, a ``<tag>.ok`` marker beside
it, and ``commit-<v>.json`` at the root. ``save`` / ``restore`` write and
read the model and AdamW state in the reference's tree (``convert``), so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models.model import DecoderLM


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists of arrays or tensors -> {"a/0/b": numpy}."""
    items = _items(tree)
    if items is None:
        leaf = (convert.to_numpy(tree) if isinstance(tree, torch.Tensor)
                else np.asarray(tree))
        return {prefix[:-1]: leaf}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _unflatten(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """The arrays of ``flat`` in ``template``'s structure, each cast to its
    template leaf's dtype and shape (a tensor leaf gives a tensor on its
    device)."""
    items = _items(template)
    if items is None:
        arr = flat[prefix[:-1]]
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(np.asarray(arr, np.float32)
                                   if template.dtype == torch.bfloat16
                                   else arr).to(
                template.device, template.dtype).reshape(template.shape)
        template = np.asarray(template)
        return np.asarray(arr).astype(template.dtype).reshape(template.shape)
    out = {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in items}
    return out if isinstance(template, dict) else [out[i]
                                                   for i in range(len(out))]


class MandatorCheckpointer:
    """n_controllers shard-writers + quorum commit. In a deployment each
    controller is one pod's host fleet; here they are invoked in-process
    (the protocol logic is the same; ``runtime/sporades_rt.py`` has the
    fallback path when controllers fail)."""

    def __init__(self, root, n_controllers: int = 1):
        self.root = Path(root)
        self.n = n_controllers
        self.f = (n_controllers - 1) // 2
        self.root.mkdir(parents=True, exist_ok=True)

    # ---- data plane -------------------------------------------------------
    def write_shard(self, controller: int, version: int, tree: Any,
                    tag: str = "state") -> bool:
        """One controller's shard write (Mandator write(B)). Returns ack."""
        d = self.root / f"c{controller}" / f"v{version}"
        d.mkdir(parents=True, exist_ok=True)
        np.savez(d / f"{tag}.npz", **_flatten(tree))
        (d / f"{tag}.ok").write_text(str(time.time()))
        return True

    # ---- control plane ----------------------------------------------------
    def try_commit(self, version: int, step: int,
                   acks: Optional[List[bool]] = None) -> bool:
        """Commit the cut if >= n-f controller shards are durable."""
        present = []
        for c in range(self.n):
            ok = (self.root / f"c{c}" / f"v{version}" / "state.ok").exists()
            if acks is not None:
                ok = ok and acks[c]
            present.append(ok)
        if sum(present) < self.n - self.f:
            return False
        manifest = {"version": version, "step": step,
                    "controllers": [c for c, p in enumerate(present) if p],
                    "time": time.time()}
        (self.root / f"commit-{version}.json").write_text(
            json.dumps(manifest))
        return True

    def latest_committed(self) -> Optional[Dict]:
        best = None
        for p in self.root.glob("commit-*.json"):
            m = json.loads(p.read_text())
            if best is None or m["version"] > best["version"]:
                best = m
        return best

    def restore(self, template: Any, controller: int = 0,
                tag: str = "state") -> Optional[Tuple[int, Any]]:
        """(step, the newest committed cut's tree in ``template``'s
        structure), or None before any commit."""
        m = self.latest_committed()
        if m is None:
            return None
        src = controller if controller in m["controllers"] \
            else m["controllers"][0]
        d = self.root / f"c{src}" / f"v{m['version']}"
        with np.load(d / f"{tag}.npz") as npz:
            flat = dict(npz)
        return m["step"], _unflatten(template, flat)


def state_tree(params: DecoderLM, opt_state: Dict) -> Dict:
    """The reference's checkpoint tree {"params": ..., "opt": ...} (numpy
    leaves) of the port's model and AdamW state."""
    return {"params": convert.model_params_to_reference(params),
            "opt": convert.opt_state_to_reference(opt_state, params.cfg)}


def load_state_tree(tree: Dict, params: DecoderLM,
                    opt_state: Dict) -> Tuple[DecoderLM, Dict]:
    """Write a checkpoint tree (the reference's layout) into ``params`` in
    place; returns (params, the AdamW state on the params' device)."""
    convert.load_params_from_reference(params, tree["params"])
    return params, convert.opt_state_from_reference(
        tree["opt"], params, device=params.final_norm.device)


def save(path, step: int, params: DecoderLM, opt_state: Dict) -> None:
    """Single-writer convenience wrapper (quickstart / tests)."""
    ck = MandatorCheckpointer(path, 1)
    ck.write_shard(0, step, state_tree(params, opt_state))
    ck.try_commit(step, step)


def restore(path, params_tmpl: DecoderLM, opt_tmpl: Dict
            ) -> Optional[Tuple[int, DecoderLM, Dict]]:
    """(step, params, opt_state) of the newest committed checkpoint,
    loaded into ``params_tmpl`` in place, or None."""
    ck = MandatorCheckpointer(path, 1)
    out = ck.restore(state_tree(params_tmpl, opt_tmpl))
    if out is None:
        return None
    step, tree = out
    params, opt = load_state_tree(tree, params_tmpl, opt_tmpl)
    return step, params, opt
