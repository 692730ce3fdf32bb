"""Channel-ring commit fused with its sends, as a CUDA kernel for Hopper
(``csrc/channel_ring.cu``), bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/channel_ring/kernel.py``
(``_commit_kernel``, wrapper ``ring_commit_tpu``) and, on the card, the
preparation the plain path runs before it (``core/channel.commit_entries``
and ``ops.pack_entries``). One launch per ring per tick reads the tick's
sends where they lie: the wrapper hands the kernel a by-value parameter
struct holding, per send, the data pointer and element strides of its
payload, delay and mask (an expanded view keeps its 0 strides and is read
in place), and its channel's static layout. One thread owns one ``(lane,
sender, receiver, field)`` column of the ring, so no atomics are needed and
the result is bitwise equal to the plain version (ref.py). See the source
for the design and its bound.

The host side costs little per tick: the struct is built and checked once
per (layout, shapes, strides, dtypes) and later calls refill only its
pointers (``describe``). Nothing synchronizes with the host. The tick
``t`` is a 0-dim int32 tensor on the ring's device, which the kernel
reads and from which it takes the delivered slot ``t % D``: a launch
captured into a CUDA graph (core/compile_cache.py) then commits whatever
tick the graph's ``t`` holds at each replay.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import device as _device
from repro_torch.kernels import _build
from repro_torch.kernels.channel_ring.ref import EntryLayout

NAME = "channel_ring"
MAX_ENTRIES = 16    # the kernel's kMaxEntries: sends per tick it takes

launch_count = 0
_built: Optional[_build.Built] = None


class _Entry(ctypes.Structure):
    """One send, as ``Entry`` in csrc/channel_ring.cu."""
    _fields_ = [("pay", ctypes.c_void_p), ("delay", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("ps", ctypes.c_int * 4),
                ("ds", ctypes.c_int * 3), ("ms", ctypes.c_int * 3),
                ("off", ctypes.c_int), ("w", ctypes.c_int),
                ("flag_off", ctypes.c_int), ("additive", ctypes.c_int)]


class Params(ctypes.Structure):
    """The kernel's by-value parameter struct, as ``Params`` in
    csrc/channel_ring.cu."""
    _fields_ = [("e", _Entry * MAX_ENTRIES), ("drop", ctypes.c_void_p),
                ("drs", ctypes.c_int * 3), ("B", ctypes.c_int),
                ("D", ctypes.c_int), ("n", ctypes.c_int), ("K", ctypes.c_int),
                ("E", ctypes.c_int)]


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        lib = built.lib
        fn = lib.channel_ring_commit
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ("channel_ring_params_size", "channel_ring_max_entries"):
            getattr(lib, name).restype = ctypes.c_int
        size, entries = (lib.channel_ring_params_size(),
                         lib.channel_ring_max_entries())
        if size != ctypes.sizeof(Params) or entries != MAX_ENTRIES:
            raise RuntimeError(
                f"csrc/channel_ring.cu's Params ({size} bytes, {entries} "
                f"entries) does not match kernel.Params "
                f"({ctypes.sizeof(Params)} bytes, {MAX_ENTRIES} entries)")
        err_str = lib.channel_ring_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _built = built
    return _built


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype} (the "
                        f"kernel converts nothing)")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if sum((n - 1) * abs(st) for n, st in zip(x.shape, x.stride())) >= 2**31:
        raise ValueError(f"{name} spans more elements than the kernel's "
                         f"32-bit offsets reach")


def _key(buf: torch.Tensor, sends, drop, layout) -> tuple:
    """What the struct depends on besides the pointers."""
    return (layout, buf.shape, buf.stride(), buf.dtype, buf.device,
            None if drop is None
            else (drop.shape, drop.stride(), drop.dtype, drop.device),
            tuple((s.payload.shape, s.payload.stride(), s.payload.dtype,
                   s.payload.device, s.delay_ticks.shape,
                   s.delay_ticks.stride(), s.delay_ticks.dtype,
                   s.delay_ticks.device, s.mask.shape, s.mask.stride(),
                   s.mask.dtype, s.mask.device) for s in sends))


def _make(buf: torch.Tensor, sends, drop,
          layout: Tuple[EntryLayout, ...]) -> Params:
    """Check the sends against the ring and fill everything of the struct
    but the pointers."""
    if buf.dim() != 5 or buf.shape[2] != buf.shape[3]:
        raise ValueError(f"buf must be [B, D, n, n, K], got "
                         f"{tuple(buf.shape)}")
    if buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous float32 tensor")
    B, D, n, _, K = buf.shape
    if B * n * n * K >= 2**31:
        raise ValueError(f"ring {tuple(buf.shape)}: more columns than the "
                         f"kernel's 32-bit thread index reaches")
    E = len(sends)
    if E > MAX_ENTRIES:
        raise ValueError(f"{E} sends in one tick; the fused commit takes at "
                         f"most {MAX_ENTRIES}")
    if len(layout) != E:
        raise ValueError(f"{len(layout)} layouts for {E} sends")
    add_offs = [off for off, _, _, additive in layout if additive]
    if len(add_offs) != len(set(add_offs)):
        raise ValueError(f"additive channel sent twice in one tick (payload "
                         f"offsets {add_offs})")
    dev = buf.device
    p = Params()
    for e, (s, (off, w, flag_off, additive)) in enumerate(zip(sends, layout)):
        if not (0 <= off and off + w <= K and 0 <= flag_off < K):
            raise ValueError(f"send {e}: layout {layout[e]} outside K={K}")
        _check(f"send {e} payload", s.payload, torch.float32, (B, n, n, w),
               dev)
        _check(f"send {e} delay_ticks", s.delay_ticks, torch.int32,
               (B, n, n), dev)
        _check(f"send {e} mask", s.mask, torch.bool, (B, n, n), dev)
        ent = p.e[e]
        ent.ps[:] = s.payload.stride()
        ent.ds[:] = s.delay_ticks.stride()
        ent.ms[:] = s.mask.stride()
        ent.off, ent.w, ent.flag_off = off, w, flag_off
        ent.additive = int(additive)
    if drop is not None:
        _check("drop", drop, torch.bool, (B, n, n), dev)
        p.drs[:] = drop.stride()
    p.B, p.D, p.n, p.K, p.E = B, D, n, K, E
    return p


_params: dict = {}


def describe(buf: torch.Tensor, sends: Sequence, drop: Optional[torch.Tensor],
             layout: Tuple[EntryLayout, ...]) -> Params:
    """The kernel's parameter struct for these sends, on any device. Built
    and checked once per (layout, shapes, strides, dtypes, devices); every
    call refills the data pointers. ``sends`` are ``core.channel.Send``s
    (anything with ``payload``, ``delay_ticks`` and ``mask``); ``layout``
    holds each send's channel ``(off, w, flag_off, additive)``. Raises for
    more than MAX_ENTRIES sends, an additive channel sent twice, and a
    payload, delay or mask of a dtype, shape or device the tick does not
    send (float32, int32, bool on buf's device)."""
    # The struct is copied into the launch's parameters, so a launch
    # captured into a CUDA graph keeps the pointers it had at the capture.
    # That is right only because the tick's sends (and drop and t) then
    # live in the graph's own memory pool, where every replay writes them
    # again at the same addresses (core/compile_cache.py).
    key = _key(buf, sends, drop, layout)
    p = _params.get(key)
    if p is None:
        if len(_params) >= 64:
            _params.clear()
        p = _params[key] = _make(buf, sends, drop, layout)
    for e, s in enumerate(sends):
        ent = p.e[e]
        ent.pay = s.payload.data_ptr()
        ent.delay = s.delay_ticks.data_ptr()
        ent.mask = s.mask.data_ptr()
    p.drop = None if drop is None else drop.data_ptr()
    return p


def ring_commit_fused(buf: torch.Tensor, t: torch.Tensor,
                      fill: torch.Tensor, sends: Sequence,
                      drop: Optional[torch.Tensor],
                      layout: Tuple[EntryLayout, ...]) -> torch.Tensor:
    """Commit tick ``t`` of these sends into ``buf`` [B, D, n, n, K]
    float32 in place, on the current stream, and return it: clear slot
    ``t % D`` to ``fill`` [K] and merge every send (see ``describe`` for
    what the sends may be). ``t`` is a 0-dim int32 tensor on buf's device
    that the kernel reads (a Python int is checked and converted); it
    must be >= 0, which the tick loop's bounds guarantee (a tensor is not
    read back to check it). Equal bitwise to ``commit_entries`` +
    ``ops.pack_entries`` + ``ring_commit_ref``."""
    global launch_count
    if not buf.is_cuda:
        raise ValueError(f"the CUDA channel-ring kernel needs CUDA tensors, "
                         f"got buf on {buf.device}")
    t = _device.tick_index(t, buf.device)
    p = describe(buf, sends, drop, layout)
    dev = buf.device
    if t.device != dev or t.dtype != torch.int32 or t.numel() != 1:
        raise ValueError(f"t must be one int32 on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (fill.device != dev or fill.dtype != torch.float32
            or tuple(fill.shape) != (buf.shape[4],)
            or not fill.is_contiguous()):
        raise ValueError(f"fill must be a contiguous float32 [{buf.shape[4]}]"
                         f" on {dev}")
    lib = build().lib
    err = lib.channel_ring_commit(
        buf.data_ptr(), fill.data_ptr(), ctypes.addressof(p), t.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("channel_ring_commit launch failed: "
                           + lib.channel_ring_error_string(err).decode())
    launch_count += 1
    return buf
