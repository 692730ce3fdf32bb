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

The reference's ``module_cost``, ``collective_stats`` and
``roofline_terms`` serve its launch dry-run (ROADMAP A17.7) and are not
ported here.
"""
from __future__ import annotations

import collections
import os
import re
import sys
import tempfile
import warnings
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

