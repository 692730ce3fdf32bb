"""Plain PyTorch version of the selective-scan kernel, as the reference's
``ssm_scan_ref``: the sequential recurrence, a Python loop over S on a
``[B, Di, N]`` fp32 state: the CPU path of ``ops.ssm_scan`` and the
yardstick the CUDA kernel is held to.

Two orders at the end. ``ssm_scan_ref`` casts the recurrence's output to
``x.dtype`` first and adds ``x * D`` after, as the reference's oracle
does. ``ssm_scan_kernel_order`` adds ``D * x`` in fp32 before one cast, as
the reference's Pallas kernel and the CUDA kernel do; it is the CPU path
of ``ops.ssm_scan``. In float32 the two agree to rounding.
"""
from __future__ import annotations

import torch


def _recurrence(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t ; y_t = h_t . C_t,
    from h = 0, as float32 [Bt, S, Di]."""
    bsz, s, di = x.shape
    n = A.shape[1]
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtf = dt[:, t].float()
        a = torch.exp(dtf[:, :, None] * A)                     # [Bt,Di,N]
        h = a * h + ((dtf * x[:, t].float())[:, :, None]
                     * B[:, t, None, :].float())
        ys.append(torch.einsum("bin,bn->bi", h, C[:, t].float()))
    return (torch.stack(ys, dim=1) if ys
            else torch.zeros((bsz, 0, di), device=x.device))


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor,
                 D: torch.Tensor) -> torch.Tensor:
    """x, dt: [Bt, S, Di]; B, C: [Bt, S, N]; A: [Di, N]; D: [Di].

    The oracle: y_t = h_t . C_t cast to x.dtype, then + D x_t (float32
    when x is bfloat16 and D float32, by promotion, as in the reference).
    """
    return _recurrence(x, dt, B, C, A).to(x.dtype) + x * D


def ssm_scan_kernel_order(x: torch.Tensor, dt: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                          D: torch.Tensor) -> torch.Tensor:
    """The same recurrence ending as the kernels do: D x_t added in
    float32, then one cast to x.dtype. The CPU path of ``ops.ssm_scan``,
    so that its dtype and rounding are the kernel's on either device."""
    y = _recurrence(x, dt, B, C, A) + x.float() * D.float()
    return y.to(x.dtype)
