"""What one captured simulator tick contains (counterpart of
``repro.distributed.hlo_analysis``, for what the audit in
``analysis/graph_lint.py`` needs).

The reference reads its compiled program's optimized HLO text. The port's
program is a tick captured as a CUDA graph, so its contents are read two
ways:

* on any device, the ops of one tick as a ``TorchDispatchMode`` sees them
  (``tick_ops``): each aten op with the dtypes of its outputs, whether
  it copies between devices, and the line of the port's source that
  issued it. ``dtype_op_counts`` and ``host_transfer_ops`` summarize
  them, as the reference's functions of the same names summarize HLO;
* on the card, the kernel nodes of the captured graph, from the graph's
  own DOT dump (``graph_kernel_nodes``).

The dry run's cost model (``launch/dryrun.py``) is here too, as the
reference keeps it in ``hlo_analysis``: ``record_cost`` records one step's
aten ops on each device's own shards (DTensor ops are counted as the local
ops they run), ``module_cost`` sums their FLOPs (``torch.utils.
flop_counter``'s formulas), bytes and collectives, ``collective_stats``
counts the collectives by kind and ``roofline_terms`` turns the sums into
seconds on an H100. The reference multiplies a while loop's body by its
trip count; eager execution runs every iteration, so the record already
holds each one.
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
import sys
import tempfile
import warnings
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the port's source tree: an op's site is its innermost frame in here
_PORT = Path(__file__).resolve().parents[1]

# the reference's HLO element-type names, for the dtypes a tick makes
# lint: allow(dtype-hygiene): names float64 so the audit can count it
DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
               torch.float16: "f16", torch.bfloat16: "bf16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}

# ops that make the host wait for the device: a scalar read back, an
# output whose size the data decides, a comparison answered on the host,
# and a tensor made from host data inside the tick (on the card, a copy
# from the host)
HOST_SYNC_OPS = ("aten::_local_scalar_dense", "aten::item",
                 "aten::is_nonzero", "aten::nonzero",
                 "aten::nonzero_static", "aten::masked_select",
                 "aten::equal", "aten::allclose", "aten::_unique2",
                 "aten::unique_consecutive", "aten::unique_dim",
                 "aten::lift_fresh", "aten::lift_fresh_copy")


@dataclass
class Op:
    """One aten op of a tick."""
    name: str                     # "aten::add"
    dtypes: tuple                 # output dtypes
    site: Optional[tuple]         # (port-relative path, line) that issued it
    cross_device: bool            # a copy between devices


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _site() -> Optional[tuple]:
    """The innermost frame of the port's source (this module aside)."""
    f = sys._getframe(2)
    here = Path(__file__).resolve()
    while f is not None:
        path = Path(f.f_code.co_filename)
        if path.is_absolute() and path.resolve() != here:
            try:
                rel = path.resolve().relative_to(_PORT)
            except ValueError:
                rel = None
            if rel is not None:
                return (rel.as_posix(), f.f_lineno)
        f = f.f_back
    return None


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = "aten::" + func.__name__.split(".")[0]
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        cross = len({x.device for x in ins + outs}) > 1 and name in (
            "aten::copy_", "aten::_to_copy", "aten::to", "aten::_copy_from",
            "aten::_copy_from_and_resize")
        self.ops.append(Op(name, tuple(DTYPE_NAMES.get(x.dtype,
                                                       str(x.dtype))
                                       for x in outs),
                           _site(), cross))
        return out


def record_ops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the recorder; returns (its result,
    the list of ``Op``s it dispatched)."""
    rec = _Recorder()
    with rec:
        out = fn(*args, **kwargs)
    return out, rec.ops


def tick_ops(protocol: str, cfg, n_ticks: int, env: Dict, draws,
             batch: int, device, reduced: bool = False) -> List[Op]:
    """The ops of the tick a run would capture (tick 1, after the eager
    warm-up tick 0), with the run's own inputs: the loop iteration
    ``harness._loop_tick`` runs, its trace writes and ``t += 1``
    included."""
    from repro_torch.core import harness
    run = harness._setup(protocol, cfg, n_ticks, env, draws, batch,
                         torch.device(device), reduced)
    harness._warm(run, protocol, cfg)
    _, ops = record_ops(harness._warm, run, protocol, cfg)
    return ops


def dtype_op_counts(ops: Sequence[Op]) -> Dict[str, int]:
    """Ops per output element type (an op with outputs of two types counts
    under each)."""
    counts: Dict[str, int] = collections.Counter()
    for op in ops:
        for d in set(op.dtypes):
            counts[d] += 1
    return dict(counts)


def host_transfer_ops(ops: Sequence[Op]) -> List[Op]:
    """The ops of ``ops`` that make the host wait for the device or move
    data between devices (``HOST_SYNC_OPS`` and copies across devices)."""
    return [op for op in ops if op.name in HOST_SYNC_OPS or op.cross_device]


# where a node's definition starts in cudaGraphDebugDotPrint's output (an
# edge line starts with its tail's name and an arrow instead); a
# definition's label may span lines, so it runs to the next definition
_NODE_RE = re.compile(r'^\s*"(graph_\d+_node_\d+)"\s*\[', re.M)
_KIND_RE = re.compile(r"\b(KERNEL|MEMCPY|MEMSET|HOST|EMPTY|GRAPH|"
                      r"EVENT_RECORD|WAIT_EVENT|MEM_ALLOC|MEM_FREE|"
                      r"EXT_SEMAS_SIGNAL|EXT_SEMAS_WAIT|CONDITIONAL|"
                      r"BATCH_MEM_OP)\b")
_MANGLED_RE = re.compile(r"(_Z[A-Za-z0-9_]+)")


def parse_graph_dot(text: str) -> Dict[str, object]:
    """Node counts of a CUDA graph's DOT dump: {"nodes": all nodes,
    "kernels": {kernel name: kernel nodes}, "types": {node type: count}}.
    A node's type is the first node-type word of its definition (KERNEL,
    MEMCPY, MEMSET, EMPTY, ...); a kernel node's name is the first
    mangled symbol in it ("?" where there is none)."""
    kernels: Dict[str, int] = collections.Counter()
    types: Dict[str, int] = collections.Counter()
    starts = [m.start() for m in _NODE_RE.finditer(text)] + [len(text)]
    for a, b in zip(starts, starts[1:]):
        body = text[a:b]
        kind = _KIND_RE.search(body)
        kind = kind.group(1) if kind else "?"
        types[kind] += 1
        if kind == "KERNEL":
            name = _MANGLED_RE.search(body)
            kernels[name.group(1) if name else "?"] += 1
    return {"nodes": len(starts) - 1, "kernels": dict(kernels),
            "types": dict(types)}


def graph_kernel_nodes(graph) -> Dict[str, object]:
    """``parse_graph_dot`` of a captured ``torch.cuda.CUDAGraph`` (captured
    with its debug mode on, as ``core/compile_cache.capture`` does),
    through its own DOT dump to a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        with warnings.catch_warnings():
            # torch announces every dump of a graph in debug mode
            warnings.simplefilter("ignore", UserWarning)
            graph.debug_dump(path)
        return parse_graph_dot(Path(path).read_text(errors="replace"))
    finally:
        os.unlink(path)



# ---- the dry run's cost model ---------------------------------------------

# the functional collectives DTensor issues (torch.ops._c10d_functional),
# each counted at its result's size, as the reference counts HLO's
COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single")

# H100 SXM data sheet (dense, no sparsity; the figures chip_smoke.py's
# bounds use): tensor-core bf16 and CUDA-core float32 peaks, HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
HBM_BW = 3.35e12                 # bytes/s
# The collectives' link. A 16-wide "model" axis holds 16 GPUs, two 8-GPU
# NVLink nodes (an HGX/DGX H100 node has 8), so every collective over it
# crosses the nodes' network, and a ring runs at its slowest link: the
# node's InfiniBand NIC, one 400 Gb/s ConnectX-7 per GPU (NVIDIA DGX H100
# data sheet), 50e9 bytes/s each way. NVLink (450e9 each way within a
# node) bounds only axes that stay inside one node.
INTERCONNECT_BW = 50e9           # bytes/s per GPU, each way


@dataclass
class CostOp:
    """One aten op of a recorded step, on one device's shards."""
    name: str                     # "aten::mm"
    flops: float
    bytes: float                  # operands + results; 0 for a view
    collective: Optional[str]     # a COLLECTIVES kind, or None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ops that move no data: allocation without a write, and the functional
# collectives' bookkeeping
_FREE = ("aten::empty", "aten::empty_strided", "aten::empty_like",
         "aten::new_empty", "aten::new_empty_strided",
         "_c10d_functional::wait_tensor",
         "_c10d_functional::_wrap_tensor_autograd")


@contextlib.contextmanager
def _marking_propagation(rec):
    """While DTensor's sharding propagation runs an op on fake stand-ins
    of the global shapes (``_propagate_tensor_meta_non_cached``, once per
    new op and shape, to read the output's shape), ``rec.propagating`` is
    set: those ops are not the step's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        rec.propagating += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            rec.propagating -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class _CostRecorder(TorchDispatchMode):
    """Records the ops that run on local tensors: a DTensor op is handed
    on (NotImplemented) to DTensor, whose local ops come back here. Ops on
    meta tensors (DTensor's sharding propagation runs each op once on
    meta stand-ins of the global shapes) and ``prim`` queries are not
    the step's and are not recorded."""

    def __init__(self):
        super().__init__()
        self.ops: List[CostOp] = []
        self.live = self.peak = 0
        self.propagating = 0
        self._held: set = set()

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns == "prim" or self.propagating:
            return out
        coll = name if ns == "_c10d_functional" and name in COLLECTIVES \
            else None
        formula = flop_registry.get(func._overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula \
            else 0.0
        if func.is_view or coll is not None or f"{ns}::{name}" in _FREE:
            byts = 0.0 if coll is None else float(sum(
                _nbytes(t) for t in _tensors(out)))
        else:
            byts = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                         + sum(_nbytes(t) for t in _tensors(out)))
        self.ops.append(CostOp(f"{ns}::{name}", flops, byts, coll))
        for t in _tensors(out):
            self.hold(t)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def record_cost(fn, *args, live=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` under the cost recorder; returns (its
    result, the ``CostOp``s that ran on this device's shards, the peak of
    live bytes on this device over the call). The peak counts the
    storages of ``live`` (the tensors held before the call: parameters,
    state, batch) and of every op's outputs, each until it is freed (a
    storage is counted once, however many views it has; its exact
    nbytes, without an allocator's rounding)."""
    rec = _CostRecorder()
    for t in _tensors(list(live)):
        rec.hold(_local(t))
    with _marking_propagation(rec), rec:
        out = fn(*args, **kwargs)
    return out, rec.ops, rec.peak


def module_cost(ops: Sequence[CostOp]) -> Dict[str, object]:
    """Per-device FLOPs, HBM bytes and collective bytes of a recorded step.

    HBM bytes are each op's operand and result bytes (a view moves none):
    eager PyTorch has no fusion boundary, so every op's inputs and outputs
    go through device memory, where the reference counts them at XLA's
    fusion boundaries. A collective's bytes are its result's size, and are
    counted under ``collective_bytes``, not HBM bytes."""
    stats = collective_stats(ops)
    return {"flops": sum(op.flops for op in ops),
            "bytes": sum(op.bytes for op in ops if op.collective is None),
            "collective_bytes": sum(v["bytes"] for v in stats.values()),
            "collectives": stats}


def collective_stats(ops: Sequence[CostOp]) -> Dict[str, Dict[str, float]]:
    """{kind: {"count", "bytes"}} for each of ``COLLECTIVES``."""
    out = {k: {"count": 0.0, "bytes": 0.0} for k in COLLECTIVES}
    for op in ops:
        if op.collective is not None:
            out[op.collective]["count"] += 1
            out[op.collective]["bytes"] += op.bytes
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, object]:
    """The three roofline terms of one step on one H100, in seconds:
    FLOPs at the data sheet's peak for ``dtype`` (the step's compute
    type), HBM bytes at 3.35 TB/s, collective bytes at
    ``INTERCONNECT_BW``; the dominant one and the step's bound."""
    compute_s = flops_per_device / PEAK_FLOPS[dtype]
    memory_s = bytes_per_device / HBM_BW
    collective_s = coll_bytes_per_device / INTERCONNECT_BW
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])
    bound = max(compute_s, memory_s, collective_s)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dom[0],
            "bound_s": bound,
            "compute_fraction": compute_s / bound if bound > 0 else 0.0}
