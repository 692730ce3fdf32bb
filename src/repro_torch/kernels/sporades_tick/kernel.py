"""The Sporades ordering tick of every lane as one CUDA kernel for Hopper
(``csrc/sporades_tick.cu``), bound with ctypes.

No Pallas kernel stands behind it: the reference's tick
(``repro/core/sporades.py``) is jnp. Its plain version is
``core/sporades._tick_chain``, some 350 PyTorch kernels a tick; the
kernel computes the same state bit for bit in one launch (see the source
for the design and its bound). It updates the Sporades state leaves in
place and writes the tick's eight sends into scratch buffers kept on the
device (``scratch``), which ``core/channel.ring_commit`` then reads where
they lie.

Nothing synchronizes with the host. The tick ``t`` is a 0-dim int32
tensor on the state's device, which the kernel reads: a launch captured
into a CUDA graph (core/compile_cache.py) runs whatever tick the graph's
``t`` holds at each replay. The scratch buffers are made once per (lanes,
replicas, device) and never freed, so the pointers a captured launch holds
stay valid.

The library is built at first use (kernels/_build.py). ``launch_count``
counts the launches this wrapper made; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

NAME = "sporades_tick"
MAX_N = 32          # the kernel's kMaxN: one warp's threads
# the tick's sends in their order, as core/sporades.py sends them: each
# one's ring channel (payload widths: ``widths``)
SENDS = ("vote", "prop", "to", "pa", "va", "pa", "ac", "vote")
CHANNELS = ("prop", "vote", "to", "pa", "va", "ac")   # the kernel's enum
# the state leaves the kernel updates, in the struct's order: (name, dtype,
# shape at n replicas after the lane axis)
STATE = (
    ("v_cur", torch.int32, lambda n: (n,)),
    ("r_cur", torch.int32, lambda n: (n,)),
    ("is_async", torch.bool, lambda n: (n,)),
    ("bh_key", torch.int32, lambda n: (n,)),
    ("bh_vc", torch.int32, lambda n: (n, n)),
    ("commit_key", torch.int32, lambda n: (n,)),
    ("cvc", torch.int32, lambda n: (n, n)),
    ("prop_key", torch.int32, lambda n: (n,)),
    ("last_vote_trig", torch.int32, lambda n: (n,)),
    ("deadline", torch.float32, lambda n: (n,)),
    ("timeout_sent_v", torch.int32, lambda n: (n,)),
    ("async_phase", torch.int32, lambda n: (n,)),
    ("my_r", torch.int32, lambda n: (n,)),
    ("my_avc", torch.int32, lambda n: (n, n)),
    ("exited_view", torch.int32, lambda n: (n,)),
    ("ac_tick", torch.float32, lambda n: (n, n)),
    ("ac_v_seen", torch.int32, lambda n: (n, n)),
    ("vote_st", torch.float32, lambda n: (n, n, 2 + n)),
    ("to_st", torch.float32, lambda n: (n, n, 2 + n)),
    ("pa_st", torch.float32, lambda n: (n, n, 1 + n)),
    ("va_st", torch.float32, lambda n: (n, n, n)),
    ("ac_st", torch.float32, lambda n: (n, n, 2 + n)))
ENV = (("delays", torch.float32), ("win_of_tick", torch.int32),
       ("alive_tab", torch.bool), ("drop_tab", torch.bool),
       ("delay_tab", torch.float32))

launch_count = 0
_built: Optional[_build.Built] = None


class Params(ctypes.Structure):
    """The kernel's by-value parameter struct, as ``Params`` in
    csrc/sporades_tick.cu."""
    _fields_ = ([(name, ctypes.c_void_p) for name, _, _ in STATE]
                + [(name, ctypes.c_void_p) for name in (
                    "coins", "ring", "lcr", "t", *(e for e, _ in ENV),
                    "pay", "delay_out", "mask_out", "drop_out", "cut_out")]
                + [("ch_off", ctypes.c_int * len(CHANNELS)),
                   ("ch_flag", ctypes.c_int * len(CHANNELS)),
                   ("pay_off", ctypes.c_int * len(SENDS)),
                   ("lcr_s", ctypes.c_int * 3)]
                + [(name, ctypes.c_int) for name in "B n D K T W V P".split()]
                + [("to_ticks", ctypes.c_float)])


def build() -> _build.Built:
    """Build (or load) the kernel's library once per process."""
    global _built
    if _built is None:
        built = _build.build(NAME)
        lib = built.lib
        lib.sporades_tick.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.sporades_tick.restype = ctypes.c_int
        for name in ("sporades_tick_params_size", "sporades_tick_max_n"):
            getattr(lib, name).restype = ctypes.c_int
        size, max_n = (lib.sporades_tick_params_size(),
                       lib.sporades_tick_max_n())
        if size != ctypes.sizeof(Params) or max_n != MAX_N:
            raise RuntimeError(
                f"csrc/sporades_tick.cu's Params ({size} bytes, n <= "
                f"{max_n}) does not match kernel.Params "
                f"({ctypes.sizeof(Params)} bytes, n <= {MAX_N})")
        lib.sporades_tick_error_string.argtypes = [ctypes.c_int]
        lib.sporades_tick_error_string.restype = ctypes.c_char_p
        _built = built
    return _built


def widths(n: int) -> Tuple[int, ...]:
    """Each send's payload width at ``n`` replicas, in ``SENDS`` order."""
    return (2 + n, 2 + 2 * n, 2 + n, 1 + n, n, 1 + n, 2 + n, 2 + n)


# Unbounded on purpose, like core/channel.fill_tensor: a captured tick
# graph holds these buffers' pointers, so none may be freed while it lives.
@functools.lru_cache(maxsize=None)
def scratch(batch: int, n: int, device: torch.device) -> Dict:
    """The tick's outputs on ``device``, made once per (lanes, replicas,
    device) and rewritten by every launch: ``pay`` [B, n, P] float32 (each
    send's payload row per sender, side by side), ``delay`` [B, n, n]
    int32, ``mask`` [8, B, n, n] bool, ``drop`` [B, n, n] bool, ``cut``
    [B, n] int32 (each sender's sends lost to cut links), and ``sends``:
    per send (its channel,
    its payload as [B, n, n, w], broadcast to every receiver by a 0
    stride, its mask)."""
    off = [0, *itertools.accumulate(widths(n))]
    pay = torch.zeros((batch, n, off[-1]), dtype=torch.float32,
                      device=device)
    mask = torch.zeros((len(SENDS), batch, n, n), dtype=torch.bool,
                       device=device)
    sends = tuple(
        (name, pay[:, :, off[e]:off[e + 1]][:, :, None, :].expand(
            -1, -1, n, -1), mask[e]) for e, name in enumerate(SENDS))
    return {"pay": pay, "pay_off": tuple(off[:-1]), "mask": mask,
            "delay": torch.zeros((batch, n, n), dtype=torch.int32,
                                 device=device),
            "drop": torch.zeros((batch, n, n), dtype=torch.bool,
                                device=device),
            "cut": torch.zeros((batch, n), dtype=torch.int32,
                               device=device),
            "sends": sends}


def _need(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
          device: torch.device, dense: bool = True) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype} (the "
                        f"kernel converts nothing)")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if dense and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if sum((k - 1) * abs(st) for k, st in zip(x.shape, x.stride())) >= 2**31:
        raise ValueError(f"{name} has more elements than the kernel's "
                         f"32-bit offsets reach")


def sporades_tick(st: Dict, t: torch.Tensor, env: Dict, lcr: torch.Tensor,
                  to_ticks: float, layout: Sequence[Tuple[int, int]]
                  ) -> Dict:
    """Run tick ``t`` of every lane of the Sporades state ``st`` in place,
    on the current stream, and return the tick's outputs (``scratch``).
    ``t``: a 0-dim int32 tensor on the state's device, >= 0 and below the
    scenario table's length (not read back to check); ``env``: the
    batched netsim env; ``lcr`` [B, n, n] int32, at any strides;
    ``to_ticks``: the view timeout in ticks (taken as float32);
    ``layout``: (payload offset, flag field) of each ring channel in
    ``CHANNELS`` order. Raises for a leaf of another dtype, shape or
    device, or a non-contiguous one (lcr aside), and for a layout outside
    the ring, before launching. Equal bitwise to
    ``core/sporades._tick_chain``."""
    global launch_count
    ring = st["ring"]["buf"]
    dev = ring.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA Sporades tick needs CUDA tensors, got "
                         f"the state on {dev}")
    B, D, n, _, K = ring.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{n} replicas; the kernel takes 1 to {MAX_N}")
    _need("ring", ring, torch.float32, (B, D, n, n, K), dev)
    if len(layout) != len(CHANNELS) or not all(
            0 <= off < K and 0 <= flag < K for off, flag in layout):
        raise ValueError(f"layout {layout}: one (offset, flag) inside "
                         f"K={K} for each of {CHANNELS}")
    p = Params()
    for name, dtype, shape in STATE:
        _need(name, st[name], dtype, (B, *shape(n)), dev)
        setattr(p, name, st[name].data_ptr())
    V = st["coins"].shape[-1]
    _need("coins", st["coins"], torch.int64, (B, V), dev)
    _need("lcr", lcr, torch.int32, (B, n, n), dev, dense=False)
    _need("t", t, torch.int32, (), dev)
    T, W = env["win_of_tick"].shape[-1], env["alive_tab"].shape[1]
    for (name, dtype), shape in zip(ENV, ((B, n, n), (B, T), (B, W, n),
                                         (B, W, n, n), (B, W, n, n))):
        _need(name, env[name], dtype, shape, dev)
        setattr(p, name, env[name].data_ptr())
    out = scratch(B, n, dev)
    p.coins, p.ring, p.lcr, p.t = (st["coins"].data_ptr(), ring.data_ptr(),
                                   lcr.data_ptr(), t.data_ptr())
    p.pay, p.delay_out, p.mask_out = (out["pay"].data_ptr(),
                                      out["delay"].data_ptr(),
                                      out["mask"].data_ptr())
    p.drop_out, p.cut_out = out["drop"].data_ptr(), out["cut"].data_ptr()
    for c, (off, flag) in enumerate(layout):
        p.ch_off[c], p.ch_flag[c] = off, flag
    p.pay_off[:] = out["pay_off"]
    p.lcr_s[:] = lcr.stride()
    p.B, p.n, p.D, p.K, p.T, p.W, p.V = B, n, D, K, T, W, V
    p.P = out["pay"].shape[-1]
    p.to_ticks = to_ticks
    lib = build().lib
    err = lib.sporades_tick(
        ctypes.addressof(p),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("sporades_tick launch failed: "
                           + lib.sporades_tick_error_string(err).decode())
    launch_count += 1
    return out
