#!/usr/bin/env python3
"""Time per launch of one kernel of several checkouts, on one card in one
call.

    python3 tools/kernel_ab.py --kernel NAME SRC [SRC ...]

NAME is ssm_scan or decode_attention.

Each SRC is the ``src`` directory of a checkout (this one's, or a parent's
unpacked with ``git archive`` into a directory that .gitignore lists).
Each runs in a process of its own, in the order given (parent, change,
change, parent compares two versions fairly): it imports ``repro_torch``
from SRC, builds that checkout's ``csrc/<kernel>.cu`` into its own
``build/``, and times its wrapper on this checkout's chip_smoke.py inputs
(CUDA events, inputs cycled past the L2), with the copies alone where the
checkout has a loads-only entry point:

  ssm_scan          ``ssm_scan_cuda`` at the Jamba mixer's [2, 2048, 16384,
                    16] in float32 and bfloat16 on the mixer's inputs
                    (phase 11), and ``ssm_scan_loads_cuda``;
  decode_attention  ``decode_attention_cuda`` at every float32 case of
                    ``DECODE_CASES`` (phase 12: SmolLM-135M's decode,
                    qwen3-14b's full and ragged cache), with its max abs
                    error against a float64 oracle, and
                    ``decode_attention_loads_cuda``.

Prints one JSON line per run and the card's name and power limit. Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ssm_scan(chip_smoke, kernel, row: dict) -> None:
    import torch
    for dtype in ("float32", "bfloat16"):
        inputs = chip_smoke.ssm_inputs(2, 2048, 16384, 16, dtype)
        nbytes = chip_smoke.ssm_bound(2, 2048, 16384, 16, dtype)[3]
        row[f"ms_{dtype}"] = chip_smoke.device_ms(chip_smoke.cycling(
            kernel.ssm_scan_cuda, inputs, nbytes), reps=10, rounds=5)
        loads = getattr(kernel, "ssm_scan_loads_cuda", None)
        row[f"loads_only_ms_{dtype}"] = None if loads is None else (
            chip_smoke.device_ms(chip_smoke.cycling(loads, inputs, nbytes),
                                 reps=10, rounds=5))
        del inputs
        torch.cuda.empty_cache()


def decode_attention(chip_smoke, kernel, row: dict) -> None:
    import torch
    for name, b, h, kh, d, s, lens, dtype, _ in chip_smoke.DECODE_CASES:
        if dtype != "float32":
            continue
        inputs = chip_smoke.decode_inputs(b, h, kh, d, s, lens, dtype)
        nbytes = chip_smoke.decode_bound(b, h, kh, d, s, lens, dtype)[3]
        out = kernel.decode_attention_cuda(*inputs)
        row[f"oracle_err_{name}"] = chip_smoke.oracle_err(out, *inputs)
        row[f"ms_{name}"] = chip_smoke.device_ms(chip_smoke.cycling(
            kernel.decode_attention_cuda, inputs, nbytes), reps=20, rounds=5)
        loads = getattr(kernel, "decode_attention_loads_cuda", None)
        row[f"loads_only_ms_{name}"] = None if loads is None else (
            chip_smoke.device_ms(chip_smoke.cycling(loads, inputs, nbytes),
                                 reps=20, rounds=5))
        del inputs, out
        torch.cuda.empty_cache()


KERNELS = {"ssm_scan": ssm_scan, "decode_attention": decode_attention}


def one(name: str, src: str) -> dict:
    sys.path.insert(0, src)
    import importlib

    import torch

    import repro_torch
    kernel = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    sys.path.insert(1, str(ROOT))
    import chip_smoke           # after repro_torch: it puts its own src first
    torch.backends.cuda.matmul.allow_tf32 = False
    row = {"kernel": name, "src": src,
           "package": str(Path(repro_torch.__file__).parent)}
    KERNELS[name](chip_smoke, kernel, row)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=KERNELS, required=True)
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)   # a child process: one SRC
    parser.add_argument("srcs", nargs="+", metavar="SRC")
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.kernel, args.srcs[0])), flush=True)
        return 0
    for src in args.srcs:
        run = subprocess.run([sys.executable, __file__, "--kernel",
                              args.kernel, "--one", src],
                             capture_output=True, text=True)
        sys.stderr.write(run.stderr[-2000:])
        if run.returncode != 0:
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
