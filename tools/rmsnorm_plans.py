#!/usr/bin/env python3
"""RMSNorm's CUDA kernel under every launch plan that fits, at the shapes
the model path gives it, on one card.

    python3 tools/rmsnorm_plans.py

For each shape: threads per row (a multiple of 32 up to 256; one CTA a
row), each plan's device time per launch (chip_smoke.device_ms, inputs
cycled past the L2 as chip_smoke phase 7 does) and its max abs error
against the plain version, beside the plan ``kernels/rmsnorm/kernel.plan``
picks, F.rms_norm and the bytes bound at 3.35 TB/s. Launches go to the
library directly, so the wrapper's launch count does not move. Prints
one JSON line per shape. Needs a card.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = ((8192, 576, "float32"), (8192, 576, "bfloat16"),
          (4, 576, "float32"), (4, 576, "bfloat16"),
          (4096, 8192, "float32"))


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as smoke
    from repro_torch.kernels.rmsnorm import kernel, ref

    if not torch.cuda.is_available():
        print("rmsnorm_plans: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(smoke.card_line())
    lib = kernel.build().lib
    dev = torch.cuda.current_device()
    for n, d, dtype in SHAPES:
        _, (x, w, _) = smoke.check_rmsnorm(n, d, dtype, False, dtype)
        out = torch.empty_like(x)
        nbytes = 2 * x.numel() * x.element_size() + d * w.element_size()
        want = ref.rmsnorm_ref(x, w)
        nvec = d // (16 // x.element_size())

        def run(x, w, out, tpr, per):
            err = lib.rmsnorm_launch(
                x.data_ptr(), None, w.data_ptr(), out.data_ptr(), n, d,
                1e-5, kernel.DTYPES[x.dtype], kernel.DTYPES[w.dtype], 1,
                tpr, per, dev, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rmsnorm_launch: {err}")

        rows_out = []
        for tpr in range(32, kernel.MAX_THREADS + 1, 32):
            per = math.ceil(nvec / tpr)
            if per > kernel.MAX_VEC or tpr - 32 >= nvec:
                continue        # past the registers, or a warp holds none
            run(x, w, out, tpr, per)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            ms = smoke.device_ms(smoke.cycling(
                lambda x, w, o: run(x, w, o, tpr, per), (x, w, out), nbytes))
            rows_out.append({"threads": tpr, "per_thread": per, "ms": ms,
                             "max_abs_err": err})
        library_ms = smoke.device_ms(smoke.cycling(
            lambda x, w: F.rms_norm(x, (d,), w, 1e-5), (x, w), nbytes))
        print(json.dumps({
            "shape": [n, d], "dtype": dtype,
            "picked": kernel.plan(n, d, x.dtype)._asdict(),
            "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3,
            "library_ms": library_ms, "plans": rows_out}), flush=True)
        del x, w, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
