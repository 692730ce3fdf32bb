"""The SSM mixers of the reference's ``repro.models.ssm``, each as
``init_*``, ``*_forward`` (train / prefill), ``*_init_state`` and
``*_decode``, in plain PyTorch: Mamba (its selective scan either as the
chunked scan below or, under ``use_kernel``, through ``kernels/ssm_scan``,
the CUDA kernel on a card), and xLSTM's mLSTM and sLSTM.

The chunked scan runs the recurrence ``h_t = a_t h_{t-1} + b_t`` chunk by
chunk, and within a chunk as a log-step doubling scan on ``[B, L, Di, N]``
fp32 (7 steps for L = 128): live memory is bounded by the chunk, never
``[B, S, Di, N]``. It associates the products differently from XLA's
``lax.associative_scan``, so the two agree to rounding, not bitwise.

With no ``h0`` and S a multiple of the chunk, the chunked scan is the
reference's ``custom_vjp`` ``_selective_scan`` (``_SelectiveScan``): its
forward keeps only the chunk-start states [nchunk, B, Di, N], and its
backward (``_sel_bwd``) recomputes each chunk's states and runs the
reversed scan for dh, so training never holds [B, S, Di, N]. The kernel
route has no backward and refuses autograd (``layers.refuse_grad``).

The mLSTM (matrix memory) forward is the reference's chunked linear
attention with log-space gates: a Python loop over S / L chunks carrying
C [B, H, dh, dh], n [B, H, dh] and the stabiliser m [B, H] in fp32, each
chunk's decay-weighted [L, L] scores contracted with q·k first and then
with v (never a [B, L, L, H, dh] tensor). The sLSTM is the reference's
sequential scan, a Python loop over S; its four recurrent head mixings
``einsum("bhe,hef->bhf")`` run as one batched product over the heads with
the four r matrices side by side, and the loop carries its state heads
first ([H, B, dh]) so that the product needs no copy a step. Neither has
a kernel: the reference has no Pallas kernel for them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _dispatch
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.layers import Weights, normal, refuse_grad


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
               device=None) -> Weights:
    """The reference's shapes and scales (``ssm.py:29-44``): w_in [d, 2Di]
    ~ N(0, 1/d), conv_w [K, Di] ~ N(0, 0.04), conv_b 0, w_bc [Di, 2N] and
    w_dt [Di, 1] ~ N(0, 1/Di), dt_bias -3, A_log = log(1..N) per channel,
    D 1, w_out [Di, d] ~ N(0, 1/Di)."""
    s = cfg.ssm
    d, di, n, k = cfg.d_model, s.expand * cfg.d_model, s.d_state, s.d_conv
    kw = dict(dtype=dtype, device=device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(di, n)
    return Weights(
        w_in=normal(gen, (d, 2 * di), d ** -0.5, dtype, device),
        conv_w=normal(gen, (k, di), 0.2, dtype, device),
        conv_b=torch.zeros((di,), **kw),
        w_bc=normal(gen, (di, 2 * n), di ** -0.5, dtype, device),
        w_dt=normal(gen, (di, 1), di ** -0.5, dtype, device),
        dt_bias=torch.full((di,), -3.0, **kw),
        A_log=a_log.to(dtype).contiguous(),
        D=torch.ones((di,), **kw),
        w_out=normal(gen, (di, d), di ** -0.5, dtype, device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, log(1 + e^x) = logaddexp(x, 0) at every x
    (F.softplus returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: [B,S,Di], w: [K,Di] depthwise causal conv, as the reference's
    shifted adds (a grouped F.conv1d would go to cuDNN, which runs float32
    in TF32 by default)."""
    if _dispatch.is_dtensor(x):
        # channel- and batch-local: each device convolves its own rows and
        # channels; a shard of S is gathered first
        from torch.distributed.tensor import Replicate, Shard
        pl = _dispatch.even_shards(x, [
            q if _dispatch.shard_dim(q) in (0, 2) else Replicate()
            for q in x.placements])
        wb = [(Shard(1), Shard(0)) if _dispatch.shard_dim(q) == 2
              else (Replicate(), Replicate()) for q in pl]
        return _dispatch.local_call(
            _causal_conv, (x, w, b),
            (tuple(pl), tuple(c[0] for c in wb), tuple(c[1] for c in wb)),
            tuple(pl))
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for j in range(k):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xs * w[j]
    return out + b


def _ssm_chunk_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1, by log-step
    doubling: after the step with offset o, position t holds the
    composition of positions t-2o+1 .. t. a, b: [B, L, Di, N] fp32;
    h0: [B, Di, N]. Returns (h_all, h_last)."""
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    off, length = 1, a.shape[1]
    while off < length:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b, b[:, -1]


def _chunked_scan(x, dt, B, C, A, D, chunk: int,
                  h0: Optional[torch.Tensor],
                  starts: Optional[list] = None) -> torch.Tensor:
    """The reference's two chunked paths in one: ``_ssm_fwd_core`` (the
    forward of ``_selective_scan``, h0 = 0 and S a multiple of the chunk)
    and the padded ``lax.scan`` branch of ``mamba_ssm`` (any S, any h0).
    Padded steps have dt = 0, so they leave the state as it was, and their
    outputs are cut off. ``starts``, when given, receives each chunk's
    start state [B, Di, N]."""
    bsz, s, di = x.shape
    n = A.shape[1]
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    xp, dtp, Bp, Cp = (F.pad(t, (0, 0, 0, pad)) if pad else t
                       for t in (x, dt, B, C))
    ys = []
    for c in range(nchunk):
        if starts is not None:
            starts.append(h)
        sl = slice(c * chunk, (c + 1) * chunk)
        dtf = dtp[:, sl].float()
        a = torch.exp(dtf[..., None] * A)                        # [B,L,Di,N]
        bmat = ((dtf * xp[:, sl].float())[..., None]
                * Bp[:, sl, None, :].float())
        h_all, h = _ssm_chunk_scan(a, bmat, h)
        y = torch.einsum("blin,bln->bli", h_all, Cp[:, sl].float())
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :s]
    return y + x * D


def _sel_bwd(x, dt, B, C, A, D, h_starts, dy, chunk: int):
    """The reference's ``_sel_bwd`` (``ssm.py:147-207``): chunk by chunk
    from the last, recompute the chunk's states from its start state, run
    the reversed scan dh_t = g_t + a_{t+1} dh_{t+1} (g_t = dy_t C_t, plus
    the next chunk's carry at its end), and reduce dh to the inputs'
    gradients. Returns (dx, ddt, dB, dC, dA, dD) in the inputs' dtypes."""
    bsz, s, di = x.shape
    n = A.shape[1]
    nchunk = s // chunk
    Af = A.float()
    dh_carry = torch.zeros((bsz, di, n), dtype=torch.float32,
                           device=x.device)
    zero = dh_carry
    dA = torch.zeros((di, n), dtype=torch.float32, device=x.device)
    parts = []
    for c in reversed(range(nchunk)):
        sl = slice(c * chunk, (c + 1) * chunk)
        dtf, xf = dt[:, sl].float(), x[:, sl].float()
        Bf = B[:, sl, None, :].float()
        dyf = dy[:, sl].float()
        hs = h_starts[c]
        a = torch.exp(dtf[..., None] * Af)                       # [B,L,Di,N]
        h_all, _ = _ssm_chunk_scan(a, (dtf * xf)[..., None] * Bf, hs)
        h_prev = torch.cat([hs[:, None], h_all[:, :-1]], dim=1)
        g = dyf[..., None] * C[:, sl, None, :].float()
        g = torch.cat([g[:, :-1], g[:, -1:] + dh_carry[:, None]], dim=1)
        a_shift = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        dh_r, _ = _ssm_chunk_scan(a_shift.flip(1), g.flip(1), zero)
        dh = dh_r.flip(1)
        parts.append((
            torch.sum(dh * dtf[..., None] * Bf, dim=3),               # dx
            torch.sum(dh * (a * Af * h_prev + xf[..., None] * Bf), dim=3),
            torch.sum(dh * (dtf * xf)[..., None], dim=2),             # dB
            torch.sum(dyf[..., None] * h_all, dim=2)))                # dC
        dA = dA + torch.sum(dh * a * dtf[..., None] * h_prev, dim=(0, 1))
        dh_carry = a[:, 0] * dh[:, 0]
    dx, ddt, dB, dC = (torch.cat(t[::-1], dim=1) for t in zip(*parts))
    dyf = dy.float()
    dx = dx + dyf * D
    dD = torch.sum(dyf * x.float(), dim=(0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dA.to(A.dtype), dD.to(D.dtype))


class _SelectiveScan(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_selective_scan``: h0 = 0, S a
    multiple of ``chunk``; saves the inputs and the chunk-start states."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, chunk: int):
        starts: list = []
        y = _chunked_scan(x, dt, B, C, A, D, chunk, None, starts)
        ctx.save_for_backward(x, dt, B, C, A, D, torch.stack(starts))
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, B, C, A, D, h_starts = ctx.saved_tensors
        return (*_sel_bwd(x, dt, B, C, A, D, h_starts, dy, ctx.chunk),
                None)


def mamba_ssm(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, A: torch.Tensor, D: torch.Tensor, chunk: int,
              h0: Optional[torch.Tensor] = None,
              use_kernel: bool = False) -> torch.Tensor:
    """Selective scan core. x, dt: [B,S,Di]; B, C: [B,S,N]; A: [Di,N];
    D: [Di]. ``use_kernel`` sends it to ``kernels/ssm_scan`` (the CUDA
    kernel for CUDA tensors), which starts from a zero state: with an
    ``h0`` that raises, where the reference would silently drop it
    (ROADMAP Queue C); under autograd it raises too (no backward). With no
    ``h0`` and S a multiple of ``chunk`` the scan is ``_SelectiveScan``
    (custom backward), else the padded chunked scan (plain autograd)."""
    if _dispatch.is_dtensor(x):
        # each device scans its own batch rows or channels (Di)
        def local(*args):
            return mamba_ssm(*args, chunk, h0=h0, use_kernel=use_kernel)

        pl = ssm_ops.placements(x)
        return _dispatch.local_call(local, (x, dt, B, C, A, D), pl, pl[0])
    if use_kernel:
        if h0 is not None:
            raise ValueError("use_kernel=True scans from a zero state; an h0 "
                             "needs use_kernel=False")
        refuse_grad("mamba_ssm(use_kernel=True) (the ssm_scan kernel)",
                    x, dt, B, C, A, D)
        return ssm_ops.ssm_scan(x, dt, B, C, A, D)
    if h0 is None and x.shape[1] % chunk == 0:
        return _SelectiveScan.apply(x, dt, B, C, A, D, chunk)
    return _chunked_scan(x, dt, B, C, A, D, chunk, h0)


def scan_inputs(p: Weights, x: torch.Tensor):
    """The mixer's input side, x: [B,S,D] -> (xc, dt, B, C, A, z): the
    selective scan's inputs (A = -exp(A_log) in fp32; D is ``p.D``) and
    the gate z."""
    xin, z = (x @ p.w_in).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xin, p.conv_w, p.conv_b))
    B, C = (xc @ p.w_bc).chunk(2, dim=-1)
    dt = _softplus(xc @ p.w_dt + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    return xc, dt, B, C, A, z


def mamba_forward(p: Weights, x: torch.Tensor, *, cfg: ModelConfig,
                  use_kernel: bool = False) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D]."""
    if _dispatch.is_dtensor(x):
        return _mamba_forward_sharded(p, x, cfg, use_kernel)
    xc, dt, B, C, A, z = scan_inputs(p, x)
    y = mamba_ssm(xc, dt, B, C, A, p.D, cfg.ssm.chunk,
                  use_kernel=use_kernel)
    y = y * F.silu(z)
    return y @ p.w_out


def _mamba_in(x, w_in, conv_w, conv_b, w_bc, w_dt, c0: int, di: int):
    """One device's channels [c0, c0 + c) of the mixer's input side (c =
    conv_b's local width): xc and z for them, and its partial sums of the
    projections that contract over the channels (B|C and dt's logit)."""
    c = conv_b.shape[0]
    xin = x @ w_in[:, c0:c0 + c]
    z = x @ w_in[:, di + c0:di + c0 + c]
    xc = F.silu(_causal_conv(xin, conv_w, conv_b))
    return xc, z, xc @ w_bc, xc @ w_dt


def _mamba_scan_local(xc, z, dtl, dt_bias, bc, A_log, D, chunk: int,
                      use_kernel: bool):
    """One device's channels of the scan and the gate: y * silu(z)."""
    B, C = bc.chunk(2, dim=-1)
    dt = _softplus(dtl + dt_bias)
    y = mamba_ssm(xc, dt, B, C, -torch.exp(A_log.float()), D, chunk,
                  use_kernel=use_kernel)
    return y * F.silu(z)


def _mamba_forward_sharded(p: Weights, x, cfg: ModelConfig,
                           use_kernel: bool):
    """``mamba_forward`` on DTensors, tensor-parallel over the channels
    (Di) where the rules shard them (conv_b, D, A_log on "model"): each
    device projects x onto its own channels of both halves of w_in (w_in
    is gathered: its column shards hold whole halves, not the channels'
    pairs), convolves and scans them (``_mamba_scan_local``, the kernel's
    or the chunked scan), and its share of the projections that contract
    over the channels (B|C, dt's logit, w_out) is a pending sum over the
    channel-sharding devices. x keeps its batch shards; a shard of S is
    gathered. Without channel shards every mesh dim runs batch-local."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    di = cfg.ssm.expand * cfg.d_model
    xpl = _dispatch.even_shards(x, [
        q if _dispatch.shard_dim(q) == 0 else Replicate()
        for q in x.placements])
    mesh = x.device_mesh
    ch = [_dispatch.shard_dim(q) == 0 and di % mesh.size(m) == 0
          and _dispatch.shard_dim(xq) != 0
          for m, (q, xq) in enumerate(zip(p.conv_b.placements, xpl))]
    r, s0, s1, s2 = Replicate(), Shard(0), Shard(1), Shard(2)

    def per(on_ch, on_x):
        return tuple(on_ch if c else (on_x if _dispatch.shard_dim(q) == 0
                                      else r) for c, q in zip(ch, xpl))

    x_pl = tuple(r if c else q for c, q in zip(ch, xpl))
    rep = tuple(r for _ in ch)
    c0, _ = _dispatch.local_span(p.conv_b, 0, per(s0, r))
    xc, z, bc, dtl = _dispatch.local_call(
        lambda *a: _mamba_in(*a, c0=c0, di=di),
        (x, p.w_in, p.conv_w, p.conv_b, p.w_bc, p.w_dt),
        (x_pl, rep, per(s1, r), per(s0, r), per(s0, r), per(s0, r)),
        (per(s2, s0), per(s2, s0), per(Partial(), s0), per(Partial(), s0)))
    # B|C and dt's logit contract over every channel: settle the sums
    bc = bc.redistribute(mesh, per(r, s0))
    dtl = dtl.redistribute(mesh, per(r, s0))
    y = _dispatch.local_call(
        lambda *a: _mamba_scan_local(*a, chunk=cfg.ssm.chunk,
                                     use_kernel=use_kernel),
        (xc, z, dtl, p.dt_bias, bc, p.A_log, p.D),
        (per(s2, s0), per(s2, s0), per(r, s0), per(s0, r), per(r, s0),
         per(s0, r), per(s0, r)), per(s2, s0))
    return _dispatch.local_call(
        lambda y, w: y @ w, (y, p.w_out), (per(s2, s0), per(s0, r)),
        per(Partial(), s0))


def mamba_init_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """{'conv': [batch, K-1, Di] of dtype, 'h': [batch, Di, N] fp32}, zero."""
    di = cfg.ssm.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.ssm.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba_decode(p: Weights, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 *, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,D] -> (y [B,1,D], new state). The state passed in is not
    changed."""
    xin, z = (x @ p.w_in).chunk(2, dim=-1)
    win = torch.cat([state["conv"], xin], dim=1)                 # [B,K,Di]
    xc = F.silu(torch.einsum("bki,ki->bi", win, p.conv_w)
                + p.conv_b)[:, None]
    B, C = (xc @ p.w_bc).chunk(2, dim=-1)
    dt = _softplus(xc @ p.w_dt + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    dtf = dt[:, 0].float()                                       # [B,Di]
    a = torch.exp(dtf[..., None] * A)                            # [B,Di,N]
    bmat = (dtf * xc[:, 0].float())[..., None] * B[:, 0, None, :].float()
    h = a * state["h"] + bmat
    y = torch.einsum("bin,bn->bi", h, C[:, 0].float()).to(x.dtype)
    y = (y + xc[:, 0] * p.D)[:, None] * F.silu(z)
    return y @ p.w_out, {"conv": win[:, 1:], "h": h}


# ===========================================================================
# mLSTM (xLSTM matrix memory): chunked linear attention with log-space gates
# ===========================================================================

def init_mlstm(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
               device=None) -> Weights:
    """The reference's shapes and scales (``ssm.py:259-275``), Di = 2d:
    wq, wk, wv, w_og [d, Di] and w_i, w_f [d, H] ~ N(0, 1/d), b_i 0, b_f 3
    (the forget gate open at init), b_og 0, w_out [Di, d] ~ N(0, 1/Di)."""
    d = cfg.d_model
    di, h = 2 * d, cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    return Weights(
        wq=normal(gen, (d, di), d ** -0.5, dtype, device),
        wk=normal(gen, (d, di), d ** -0.5, dtype, device),
        wv=normal(gen, (d, di), d ** -0.5, dtype, device),
        w_i=normal(gen, (d, h), d ** -0.5, dtype, device),
        b_i=torch.zeros((h,), **kw),
        w_f=normal(gen, (d, h), d ** -0.5, dtype, device),
        b_f=torch.full((h,), 3.0, **kw),
        w_og=normal(gen, (d, di), d ** -0.5, dtype, device),
        b_og=torch.zeros((di,), **kw),
        w_out=normal(gen, (di, d), di ** -0.5, dtype, device))


def _sqrt_dh(dh: int, dtype: torch.dtype) -> float:
    """sqrt(float32(dh)) rounded to ``dtype``, as the reference's
    ``jnp.sqrt(jnp.float32(dh)).astype(x.dtype)`` (a Python float divisor
    would enter a bf16 division unrounded)."""
    root = torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    return float(root.to(dtype))


def _mlstm_gates(p: Weights, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log i, log f) [B, S, H] in fp32: the exponential input gate's
    pre-activation and the log sigmoid of the forget gate's (<= 0)."""
    log_i = (x @ p.w_i).float() + p.b_i
    f_raw = (x @ p.w_f).float() + p.b_f
    return log_i, F.logsigmoid(f_raw)


def mlstm_forward(p: Weights, x: torch.Tensor, *,
                  cfg: ModelConfig) -> torch.Tensor:
    """Chunked mLSTM, x: [B,S,D] -> [B,S,D]; S must be a multiple of
    L = min(cfg.ssm.chunk, S) (the reference asserts it)."""
    bsz, s, d = x.shape
    h, di = cfg.n_heads, 2 * d
    dh = di // h
    L = min(cfg.ssm.chunk, s)
    if s % L:
        raise ValueError(f"mlstm_forward: S = {s} is not a multiple of the "
                         f"chunk {L}")
    dev = x.device
    q = (x @ p.wq).reshape(bsz, s, h, dh)
    k = (x @ p.wk).reshape(bsz, s, h, dh) / _sqrt_dh(dh, x.dtype)
    v = (x @ p.wv).reshape(bsz, s, h, dh)
    log_i, log_f = _mlstm_gates(p, x)                          # [B,S,H]
    C = torch.zeros((bsz, h, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((bsz, h, dh), dtype=torch.float32, device=dev)
    m = torch.full((bsz, h), -1e30, dtype=torch.float32, device=dev)
    causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    ys = []
    for c in range(s // L):
        sl = slice(c * L, (c + 1) * L)
        qb, kb, vb = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ib, fb = log_i[:, sl], log_f[:, sl]
        cf = torch.cumsum(fb, dim=1)                 # cumulative log f
        gmax = torch.cummax(ib - cf, dim=1).values
        m_t = cf + torch.maximum(m[:, None], gmax)               # [B,L,H]
        # intra-chunk decay-weighted scores [B, L(t), L(tau), H]
        w_log = (cf[:, :, None] - cf[:, None, :] + ib[:, None, :, :]
                 - m_t[:, :, None])
        w = torch.where(causal[None, :, :, None], torch.exp(w_log), 0.0)
        qkw = torch.einsum("blhe,bthe->blth", qb, kb) * w
        num = torch.einsum("blth,bthe->blhe", qkw, vb)
        den = qkw.sum(dim=2)
        # the carried state's contribution
        scale = torch.exp(m[:, None] + cf - m_t)                 # [B,L,H]
        num = num + scale[..., None] * torch.einsum("blhe,bhef->blhf", qb, C)
        den = den + scale * torch.einsum("blhe,bhe->blh", qb, n)
        y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        ys.append(y.to(x.dtype))
        # the state at the chunk's end
        m_new = m_t[:, -1]                                       # [B,H]
        s_dec = torch.exp(m + cf[:, -1] - m_new)
        k_w = torch.exp(cf[:, -1:] - cf + ib - m_new[:, None])   # [B,L,H]
        C = s_dec[..., None, None] * C + torch.einsum(
            "blhe,blhf->bhef", k_w[..., None] * kb, vb)
        n = s_dec[..., None] * n + torch.einsum("blh,blhe->bhe", k_w, kb)
        m = m_new
    y = torch.cat(ys, dim=1).reshape(bsz, s, di)
    og = torch.sigmoid(x @ p.w_og + p.b_og)
    return (y * og) @ p.w_out


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """{'C': [batch, H, dh, dh], 'n': [batch, H, dh] zeros, 'm': [batch, H]
    at -1e30}, all fp32 (``dtype`` is not used, as in the reference)."""
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **kw),
            "n": torch.zeros((batch, h, dh), **kw),
            "m": torch.full((batch, h), -1e30, **kw)}


def mlstm_decode(p: Weights, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 *, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,D] -> (y [B,1,D], new state): the recurrent form. The state
    passed in is not changed."""
    bsz, _, d = x.shape
    h, di = cfg.n_heads, 2 * d
    dh = di // h
    q = (x @ p.wq).reshape(bsz, h, dh).float()
    # the reference divides by a float32 scalar here, which promotes a
    # bf16 projection to float32 first
    k = (x @ p.wk).reshape(bsz, h, dh).float() / _sqrt_dh(dh, torch.float32)
    v = (x @ p.wv).reshape(bsz, h, dh).float()
    log_i, log_f = _mlstm_gates(p, x)
    log_i, log_f = log_i[:, 0], log_f[:, 0]                      # [B,H]
    lfm = log_f + state["m"]
    m_new = torch.maximum(lfm, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(lfm - m_new)
    C = f_p[..., None, None] * state["C"] + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * state["n"] + i_p[..., None] * k
    num = torch.einsum("bhe,bhef->bhf", q, C)
    den = torch.einsum("bhe,bhe->bh", q, n)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    og = torch.sigmoid(x @ p.w_og + p.b_og)
    return (y * og) @ p.w_out, {"C": C, "n": n, "m": m_new}


# ===========================================================================
# sLSTM: sequential scalar LSTM with exponential gating and head mixing
# ===========================================================================

_GATES = ("i", "f", "z", "o")


def init_slstm(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
               device=None) -> Weights:
    """The reference's shapes and scales (``ssm.py:390-402``), Di = 2d,
    dh = Di / H: w_{i,f,z,o} [d, Di] ~ N(0, 1/d), b_f 3 and b_{i,z,o} 0,
    r_{i,f,z,o} [H, dh, dh] ~ N(0, 1/dh), w_out [Di, d] ~ N(0, 1/Di)."""
    d = cfg.d_model
    di, h = 2 * d, cfg.n_heads
    dh = di // h
    w = {"w_out": normal(gen, (di, d), di ** -0.5, dtype, device)}
    for g in _GATES:
        w[f"w_{g}"] = normal(gen, (d, di), d ** -0.5, dtype, device)
        w[f"b_{g}"] = torch.full((di,), 3.0 if g == "f" else 0.0,
                                 dtype=dtype, device=device)
    for g in _GATES:
        w[f"r_{g}"] = normal(gen, (h, dh, dh), dh ** -0.5, dtype, device)
    return Weights(**w)


def _slstm_inputs(p: Weights, x: torch.Tensor, heads: int) -> torch.Tensor:
    """The four gates' input projections x @ w_g + b_g, x: [B,S,D] ->
    [S, H, B, 4, dh] (time, then heads first, as the loop reads them)."""
    bsz, s, _ = x.shape
    xp = torch.stack([x @ getattr(p, f"w_{g}") + getattr(p, f"b_{g}")
                      for g in _GATES], dim=2)                  # [B,S,4,Di]
    xp = xp.reshape(bsz, s, 4, heads, -1)
    return xp.permute(1, 3, 0, 2, 4).contiguous()


def _recurrent(p: Weights, dtype) -> torch.Tensor:
    """r_{i,f,z,o} side by side, [H, dh, 4 dh], in ``dtype``."""
    return torch.cat([getattr(p, f"r_{g}").to(dtype) for g in _GATES],
                     dim=-1)


def _slstm_step(r: torch.Tensor, carry, xp: torch.Tensor):
    """One step. carry: (c, n, h, m), each [H, B, dh] (h in the
    activations' dtype, the others fp32); r: [H, dh, 4 dh], the four
    recurrent matrices side by side in h's dtype; xp: [H, B, 4, dh]."""
    c, n, hh, m = carry
    pre = xp + torch.bmm(hh, r).view(xp.shape)
    i_raw = pre[:, :, 0].float()
    f_raw = pre[:, :, 1].float()
    z = torch.tanh(pre[:, :, 2].float())
    o = torch.sigmoid(pre[:, :, 3].float())
    lfm = F.logsigmoid(f_raw) + m
    m_new = torch.maximum(lfm, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(lfm - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = (o * c_new / torch.clamp(n_new, min=1.0)).to(hh.dtype)
    return c_new, n_new, h_new, m_new


def slstm_forward(p: Weights, x: torch.Tensor, *,
                  cfg: ModelConfig) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D], one step at a time from a zero state."""
    bsz, s, d = x.shape
    h = cfg.n_heads
    dh = 2 * d // h
    xp = _slstm_inputs(p, x, h)
    r = _recurrent(p, x.dtype)
    kw = dict(dtype=torch.float32, device=x.device)
    zero = torch.zeros((h, bsz, dh), **kw)
    carry = (zero, zero, torch.zeros((h, bsz, dh), dtype=x.dtype,
                                     device=x.device),
             torch.full((h, bsz, dh), -1e30, **kw))
    hs = []
    for t in range(s):
        carry = _slstm_step(r, carry, xp[t])
        hs.append(carry[2])
    y = torch.stack(hs).permute(2, 0, 1, 3).reshape(bsz, s, 2 * d)
    return y @ p.w_out


def slstm_init_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """{'c', 'n': zeros, 'h': zeros of ``dtype``, 'm': -1e30}, each
    [batch, Di] (c, n, m fp32)."""
    di = 2 * cfg.d_model
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **kw),
            "n": torch.zeros((batch, di), **kw),
            "h": torch.zeros((batch, di), dtype=dtype, device=device),
            "m": torch.full((batch, di), -1e30, **kw)}


def slstm_decode(p: Weights, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 *, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,D] -> (y [B,1,D], new state). The state passed in is not
    changed."""
    bsz = x.shape[0]
    h = cfg.n_heads

    def heads(t):                                     # [B, Di] -> [H, B, dh]
        return t.reshape(bsz, h, -1).transpose(0, 1)

    carry = tuple(heads(state[k]) for k in ("c", "n", "h", "m"))
    c, n, hh, m = _slstm_step(_recurrent(p, state["h"].dtype), carry,
                              _slstm_inputs(p, x, h)[0])
    new = {k: t.transpose(0, 1).reshape(bsz, -1)
           for k, t in (("c", c), ("n", n), ("h", hh), ("m", m))}
    return new["h"][:, None] @ p.w_out, new
