#!/usr/bin/env python3
"""Where the float32 tensor-core flash kernel (3xTF32) loses accuracy, on
one card.

    python3 tools/tf32_accuracy.py

Two parts, printed as JSON lines, then the card's name and power limit:

1. The tensor cores' accumulation, read through the kernel itself. With
   q = 0 every score is 0, every probability exactly 1 (ex2 of 0) and every
   rescale exactly 1, so each output is (sum of v over the row's keys) /
   (their count), summed by the m16n8k8 products: for each 8-key block
   p_hi v_lo, then p_hi v_hi (p_lo = 0) into a zeroed temporary, which is
   added to the output's sum in float32. The kernel's outputs are held bit
   for bit against models of one fused product step: the eight products
   and the temporary summed exactly and rounded once to float32 to nearest
   ("rn-exact") or toward zero ("rz-exact"), and the same with each term
   first cut toward zero to 23 + ``extra`` bits below the largest term's
   leading bit, in groups of 4 or 8 products ("rz-align-e{extra}-k{group}").

2. Whole attention on q, k, v ~ N(0, 1): the kernel, its CPU twin
   (``ref.attention_tf32x3_order``) with each rounding, and the CUDA-core
   kernel, against a float64 oracle, at SmolLM-135M's and qwen3-14b's
   prefill shapes of chip_smoke.py phase 7; then the kernel and the
   CUDA-core kernel alone at S = 32 768 (the longest prefill of the
   configs, configs/base.py prefill_32k), on a batch of 1 and one KV
   group of each model's heads, against the oracle computed in float64
   by query chunks.

Needs a card; imports the port from this checkout.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def oracle64(q, k, v, causal=True, chunk=1024):
    """attention in float64, query rows in chunks (the scores of a chunk
    only are held)."""
    import torch
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    kd, vd = k.double(), v.double()
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    keys = torch.arange(k.shape[1], device=q.device)
    for r0 in range(0, sq, chunk):
        qc = q[:, r0:r0 + chunk].double().reshape(b, -1, kh, g, d)
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, kd) / math.sqrt(d)
        if causal:
            rows = torch.arange(r0, r0 + qc.shape[1], device=q.device)
            s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p, vd)
        out[:, r0:r0 + chunk] = o.reshape(b, -1, h, d)
        del s, p, o
    return out


def model_sums(v, rounding: str, extra=None, group=8):
    """Part 1's model for one KV head: v [S, D] float32. Returns float32
    [S, D], row i = (sum of v[:i + 1] in the kernel's product steps and
    float32 adds) / (i + 1)."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    s, d = v.shape
    vh = ref.to_tf32(v)
    vl = ref.to_tf32(v - vh)
    acc = torch.zeros((s, d), dtype=torch.float32, device=v.device)
    rows = torch.arange(s, device=v.device)[:, None, None]
    for k0 in range(0, s, 8):
        keys = torch.arange(k0, min(k0 + 8, s), device=v.device)
        vis = (keys[None, None, :] <= rows).double()        # [S, 1, 8]
        t = torch.zeros_like(acc)
        for part in (vl, vh):
            prods = vis * part[k0:k0 + 8].double().T[None]   # [S, D, 8]
            for g0 in range(0, prods.shape[-1], group):
                t = ref.fused_step(t, prods[..., g0:g0 + group], rounding,
                                   extra)
        acc = acc + t
    count = torch.arange(1, s + 1, device=v.device, dtype=torch.float32)
    return acc / count[:, None]


def part_accumulation(d: int, s: int = 1024) -> dict:
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    k = torch.randn((1, s, 1, d), generator=gen, device="cuda")
    v = torch.randn((1, s, 1, d), generator=gen, device="cuda")
    q = torch.zeros((1, s, 2, d), device="cuda")
    out = fk.flash_attention_cuda(q, k, v, causal=True)[0, :, 0]
    models = {"rn-exact": ("rn", None, 8), "rz-exact": ("rz", None, 8)}
    for extra in (0, 1, 2, 3):
        for group in (4, 8):
            models[f"rz-align-e{extra}-k{group}"] = ("rz", extra, group)
    row = {"part": "accumulation", "D": d, "S": s, "models": {}}
    for name, (rounding, extra, group) in models.items():
        want = model_sums(v[0, :, 0], rounding, extra, group)
        same = (out.view(torch.int32) == want.view(torch.int32))
        diff = (out.double() - want.double()).abs()
        ulp = torch.finfo(torch.float32).eps * want.double().abs()
        row["models"][name] = {
            "bitwise_equal_share": same.double().mean().item(),
            "max_abs_diff": diff.max().item(),
            "max_diff_ulps": (diff / ulp.clamp_min(1e-45)).max().item()}
    exact = oracle64(q, k, v)[0, :, 0]
    row["kernel_vs_float64_max_abs"] = (out.double() - exact).abs().max(
        ).item()
    row["kernel_vs_float64_mean_signed"] = (
        (out.double() - exact) * exact.sign()).mean().item()
    return row


def part_attention(name, b, s, h, kh, d, twin=True) -> dict:
    import torch
    from chip_smoke import flash_cuda_core
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    out = fk.flash_attention_cuda(q, k, v, causal=True)
    exact = oracle64(q, k, v)

    def err(x):
        return (x.double() - exact).abs().max().item()

    row = {"part": "attention", "case": name, "shape": [b, s, h, kh, d],
           "kernel_err": err(out),
           "kernel_signed_mean_rel": ((out.double() - exact)
                                      * exact.sign()).mean().item()
           / exact.abs().mean().item(),
           "cuda_core_err": err(flash_cuda_core(q, k, v, True)),
           "float32_ref_err": None}
    if twin:
        row["float32_ref_err"] = err(ref.attention_ref(q, k, v))
        bk = fk.tf32_block_k(d)
        for rounding in ("rn", "rz"):
            t = ref.attention_tf32x3_order(q, k, v, block_k=bk,
                                           rounding=rounding)
            row[f"twin_{rounding}_err"] = err(t)
            row[f"kernel_vs_twin_{rounding}"] = (out - t).abs().max().item()
            del t
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tf32_accuracy: torch sees no CUDA device", file=sys.stderr)
        return 1
    import subprocess
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in (64, 128):
        print(json.dumps(part_accumulation(d)), flush=True)
    for args in (("smollm-prefill", 4, 2048, 9, 3, 64),
                 ("qwen3-14b-D128", 1, 2048, 40, 8, 128)):
        print(json.dumps(part_attention(*args)), flush=True)
    for args in (("smollm-32k", 1, 32768, 3, 1, 64),
                 ("qwen3-14b-32k", 1, 32768, 5, 1, 128)):
        print(json.dumps(part_attention(*args, twin=False)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
