"""Sharding rules: DP / FSDP / TP / EP / SP per (arch x shape), as DTensor
placements (port of ``repro.distributed.sharding``).

Mesh axes: ("pod", "data", "model") multi-pod, ("data", "model") single pod.
- batch        -> ("pod", "data")   [DP; pod axis is pure DP]
- weights      -> TP over "model" on head/ffn/expert/channel dims; FSDP over
                  "data" on the other big dim for >=20B-param archs (ZeRO-3)
- experts      -> EP over "model" (leading expert dim)
- KV cache     -> batch over "data", sequence over "model" (SP decode)
- optimizer    -> same specs as params (``launch/dryrun._opt_shardings``)

Every rule degrades to replication when a dim is not divisible by the axis
size (e.g. smollm's 9 heads).

A rule returns a spec, as the reference's ``PartitionSpec``: a tuple with
one entry a dim, ``None`` (whole), an axis name or a tuple of axis names.
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``:
mesh dim ``a`` gets ``Shard(d)`` where dim ``d``'s entry names ``a``, else
``Replicate()``; a dim over ``("pod", "data")`` is ``Shard(d)`` on both,
pod-major, as JAX splits it. The rules read only the mesh's axis names
and sizes, so a ``MeshShape`` stands in for a mesh no process group backs.

Two layouts differ from the reference's. Its parameters stack each
super-block position's layers (``blocks/i/<name>``, a leading R, spec
``(None, *rest)``); the port has one module a layer
(``layers.{r*period+i}.<name>``, ``convert``'s map), whose leaf takes
``rest``. Its caches are ``[R, B, ...]``, the port's ``[B, ...]`` a layer,
so the cache rules read one dim less.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, param_count

FSDP_THRESHOLD = 20_000_000_000  # params; above this, shard weights over data

Axis = Optional[object]          # None, an axis name, or a tuple of names
Spec = Tuple[Axis, ...]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices (what the rules read
    of a ``DeviceMesh``)."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis(mesh, name: str) -> Optional[str]:
    return name if name in mesh.mesh_dim_names else None


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _names(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def _prod_axes(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    k = 1
    for a in _names(axes):
        k *= sizes[a]
    return k


def _div(n: int, mesh, axis) -> bool:
    if axis is None:
        return False
    return n % _prod_axes(mesh, axis) == 0


def param_pspec(path: str, shape: Tuple[int, ...], mesh, *, fsdp: bool,
                stacked: bool = False, policy: str = "tp") -> Spec:
    """Sharding rule for one parameter leaf (the reference's rule, name for
    name). ``path`` is the leaf's name (the port's ``layers.3.mixer.wq``
    or the reference's ``blocks/0/mixer/wq``); ``stacked`` leaves carry a
    leading repeats dim.

    Policies:
      tp        — baseline TP(+FSDP) rules
      seqpar    — replicate every weight; activations are sequence-sharded
                  via CallConfig.seq_axis
      tp_gqa    — as tp, but KV projections replicated (pairs with
                  CallConfig.gqa_expand_kv: head-aligned attention TP)
      ep_data   — as tp_gqa, but MoE experts sharded over the *data* axis
      ep_seq    — experts over data, dense weights FSDP over data only
    """
    lead = (None,) if stacked else ()
    dims = shape[1:] if stacked else shape
    model = _axis(mesh, "model")
    data = _axis(mesh, "data") if fsdp else None

    def ok(i, ax):  # divisibility guard
        return ax if _div(dims[i], mesh, ax) else None

    name = path.replace("/", ".").split(".")[-1]
    if policy == "seqpar":
        return (*lead, *([None] * len(dims)))
    if "embed" in path or name == "head":
        if name == "embed":
            return (*lead, ok(0, model), None)          # [V, D]
        return (*lead, None, ok(1, model))              # [D, V]
    if name in ("final_norm", "norm1", "norm2", "cross_norm"):
        return (*lead, None)
    if len(dims) == 3 and name in ("w_gate", "w_up", "w_down"):
        # MoE expert weights [E, D, F] / [E, F, D]
        if policy in ("ep_data", "ep_seq"):
            e_ax = ok(0, _axis(mesh, "data"))
            f_idx = 2 if name != "w_down" else 1
            spec = [e_ax, None, None]
            if _div(dims[f_idx], mesh, model):
                spec[f_idx] = model
            return (*lead, *spec)
        e_ax = ok(0, model)
        f_ax = ok(1, data) if e_ax else ok(1, model)
        return (*lead, e_ax, f_ax, None)
    if name == "router":
        return (*lead, None, None)
    if policy == "ep_seq":
        fs = _axis(mesh, "data")
        if len(dims) == 2:
            return (*lead, ok(0, fs), None)
        if len(dims) == 1:
            return (*lead, None)
    if policy in ("tp_gqa", "ep_data") and name in ("wk", "wv", "bk", "bv"):
        return (*lead, *([None] * len(dims)))           # replicate KV proj
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_og",
                "w_i", "w_f", "w_z", "w_o"):
        return (*lead, ok(0, data), ok(1, model))       # [D, out]
    if name in ("wo", "w_down", "w_out"):
        return (*lead, ok(0, model), ok(1, data))       # [in, D]
    if name in ("bq", "bk", "bv", "conv_b", "dt_bias", "b_og", "b_i", "b_f",
                "b_z", "b_o", "D"):
        return (*lead, ok(0, model))
    if name in ("w_bc", "w_dt", "A_log"):
        return (*lead, ok(0, model), None)              # [Di, *]
    if name == "conv_w":
        return (*lead, None, ok(1, model))              # [K, Di]
    if name.startswith("r_"):                            # sLSTM [H, dh, dh]
        return (*lead, None, None, ok(2, model))
    if name in ("q_norm", "k_norm"):
        return (*lead, None)
    return (*lead, *([None] * len(dims)))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = [Replicate()] * len(mesh.mesh_dim_names)
    index = {a: i for i, a in enumerate(mesh.mesh_dim_names)}
    for d, entry in enumerate(spec):
        names = _names(entry)
        if [index[a] for a in names] != sorted(index[a] for a in names):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"the mesh's order {mesh.mesh_dim_names}")
        for a in names:
            out[index[a]] = Shard(d)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard (every sharded dim divides, as the
    rules' divisibility guards make it)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        k = _prod_axes(mesh, entry)
        if out[d] % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry}")
        out[d] //= k
    return tuple(out)


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def param_shardings(cfg: ModelConfig, mesh, params,
                    policy: str = "tp") -> Dict[str, NamedSharding]:
    """{parameter name: NamedSharding} for a DecoderLM (any device, meta
    included) or a {name: tensor or shape} mapping."""
    fsdp = param_count(cfg) >= FSDP_THRESHOLD
    return {n: NamedSharding(mesh, param_pspec(n, s, mesh, fsdp=fsdp,
                                               policy=policy))
            for n, s in _named_shapes(params).items()}


def _batch_axis(b: int, mesh) -> Axis:
    baxes = batch_axes(mesh)
    if baxes and _div(b, mesh, baxes):
        return baxes
    if "data" in mesh.mesh_dim_names and _div(b, mesh, "data"):
        return ("data",)
    return None


def batch_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """Input batch leaf: the leading batch dim over (pod, data)."""
    if len(shape) == 0:
        return ()
    return (_batch_axis(shape[0], mesh), *([None] * (len(shape) - 1)))


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    batch: Mapping[str, Any]) -> Dict[str, NamedSharding]:
    """{batch key: NamedSharding}; ``batch`` maps keys to tensors or
    shapes."""
    return {k: NamedSharding(mesh, batch_pspec(tuple(getattr(v, "shape", v)),
                                               mesh))
            for k, v in batch.items()}


def cache_pspec(name: str, shape: Tuple[int, ...], mesh,
                stacked: bool = False) -> Spec:
    """KV/recurrent cache leaf: batch -> data axes, long dims -> model (SP).
    The port's leaf is one layer's [B, ...]; ``stacked`` reads the
    reference's [R, B, ...]."""
    lead = (None,) if stacked else ()
    dims = shape[1:] if stacked else shape
    model = _axis(mesh, "model")
    b_ax = _batch_axis(dims[0], mesh)
    rest: list = [None] * (len(dims) - 1)
    if name in ("k", "v"):
        # [B, S, Kh, Dh]: shard the sequence (SP decode)
        s_ax = model
        both = (("data", "model") if "data" in mesh.mesh_dim_names
                else model)
        if b_ax is None and _div(dims[1], mesh, both):
            s_ax = tuple(a for a in ("data", "model")
                         if a in mesh.mesh_dim_names)
        if _div(dims[1], mesh, s_ax):
            rest[0] = s_ax
    elif name in ("conv", "h", "C", "n", "m", "c"):
        # recurrent state: shard the channel dim over model
        #   mamba: conv [B,K,Di]->Di@1, h [B,Di,N]->Di@0
        #   mlstm: C [B,H,dk,dv]->dk@1, n [B,H,dk]->dk@1, m: none
        #   slstm: c/n/h/m [B,Di]->Di@0
        if len(dims) == 2:
            ch_idx = 0
        elif name == "conv":
            ch_idx = 1
        elif name == "h":
            ch_idx = 0
        elif name in ("C", "n"):
            ch_idx = 1
        else:
            ch_idx = None
        if ch_idx is not None and ch_idx < len(rest) \
                and _div(dims[1 + ch_idx], mesh, model):
            rest[ch_idx] = model
    return (*lead, b_ax, *rest)


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    cache: List[Mapping[str, Any]]
                    ) -> List[Dict[str, NamedSharding]]:
    """One {leaf name: NamedSharding} a layer of ``init_cache``'s list."""
    return [{k: NamedSharding(mesh, cache_pspec(
                k, tuple(getattr(v, "shape", v)), mesh))
             for k, v in layer.items()} for layer in cache]


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the same whole tensor on every rank) as a DTensor with
    ``sharding``'s placements: each rank keeps its own shard, no data
    moves between ranks."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_params(params: torch.nn.Module,
                 shardings: Mapping[str, NamedSharding]) -> torch.nn.Module:
    """Replace every parameter of ``params`` by a DTensor parameter placed
    by ``shardings`` (in place; returns ``params``)."""
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        setattr(mod, leaf, torch.nn.Parameter(
            place(p.detach(), shardings[name]),
            requires_grad=p.requires_grad))
    return params


def place_tree(tree, shardings):
    """A dict / list tree of tensors placed by the same-shaped tree of
    NamedShardings."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, s) for v, s in zip(tree, shardings)]
    return place(tree, shardings)


def constrain_activations(x, mesh):
    """Batch-shard ``x`` (a DTensor) over the mesh's data axes where its
    leading dim divides; anything else passes through."""
    if mesh is None or not isinstance(x, _dtensor_cls()):
        return x
    baxes = batch_axes(mesh)
    if baxes and x.shape[0] % _prod_axes(mesh, baxes) == 0:
        spec = (baxes, *([None] * (x.dim() - 1)))
        return x.redistribute(mesh, placements(spec, mesh))
    return x
