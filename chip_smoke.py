#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

  1. card   — nvidia-smi's name and power limit;
  2. build  — nvcc builds the channel-ring kernel from csrc/ (sm_90a);
  3. kernel — random tick traffic (drops, in-slot collisions, 2*D ticks,
              D=256, B=16) through the sporades, mandator and additive ring
              layouts, kernel and plain PyTorch version bitwise equal after
              every tick; time per launch of both (CUDA events) beside the
              bytes-based bound at 3.35 TB/s;
  4. main   — the Fig-6 sweep at full size through the port's entry point:
              run_sweep("mandator-sporades", SMRConfig(), 4 rates x 4
              seeds) = 16 lanes, n=5, 10 000 ticks, D=256, with the kernel
              on the path (launch counts read around this run only);
  5. profile — ticks 500-700 of that grid run twice from one state,
              untraced (wall per tick) and under torch.profiler (kernel
              launches and device busy time per tick, the top kernels);
  6. whole path — 2 s runs of baseline and leader-crash-recover with the
              kernel and with the plain version, bitwise equal; the same
              points on the card and on the CPU from one arrival table,
              bitwise equal;
  7. the card's line, the kernels line, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
B, D = 16, 256                     # the Fig-6 grid's lanes and ring slots
FIG6_RATES = (50_000, 150_000, 300_000, 450_000)
FIG6_SEEDS = (0, 1, 2, 3)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_sends(spec, names, n, gen, ch):
    """One tick of random traffic: payload uniform in [-1, 50), delays in
    [0, 2D) (clipped to [1, D-1] by the commit, so slots collide), masks
    and drops at random."""
    import torch
    sends = []
    for name in names:
        w = spec[name].width
        pay = torch.rand((B, n, n, w), generator=gen, device="cuda") * 51 - 1
        delay = torch.randint(0, 2 * D, (B, n, n), generator=gen,
                              device="cuda", dtype=torch.int32)
        mask = torch.rand((B, n, n), generator=gen, device="cuda") < 0.5
        sends.append(ch.Send(name, pay, delay, mask))
    drop = torch.rand((B, n, n), generator=gen, device="cuda") < 0.2
    return sends, drop


def layouts():
    from repro_torch.core import channel as ch
    from repro_torch.core import mandator, sporades
    return {
        # the sporades tick's eight sends, in its order
        "sporades": (sporades.ring_spec(5),
                     ("vote", "prop", "to", "pa", "va", "pa", "ac", "vote")),
        "mandator": (mandator.ring_spec(), ("vote", "batch")),
        # max-merged and additive channels, as in tests/test_kernels.py
        "additive": (ch.RingSpec(ch.ChannelSpec("a", 2),
                                 ch.ChannelSpec("fw", 2, additive=True),
                                 ch.ChannelSpec("b", 3)),
                     ("a", "fw", "b", "a")),
    }


def device_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Median over ``rounds`` of the device time per call of ``fn``: the
    calls are queued behind a sleep kernel so that CUDA events time the
    device's work, not the host's launch gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def bound_bytes(buf, slots, vals, flags, table, layout) -> int:
    """Bytes one commit must move with these inputs: every input read once,
    the cleared slot written once, and each ring cell a live send (flag 1)
    targets read and written once."""
    import torch
    Bn, Dn, n, _, K = buf.shape
    E = slots.shape[-1]
    cells = []
    b = torch.arange(Bn, device="cuda").view(Bn, 1, 1)
    ij = torch.arange(n * n, device="cuda").view(1, n, n)
    for e, (off, w, flag_off, _) in enumerate(layout):
        live = flags[..., e] > 0.5
        base = ((b * Dn + slots[..., e].long()) * n * n + ij) * K
        fields = list(range(off, off + w)) + [flag_off]
        for f in fields:
            cells.append((base + f)[live])
    touched = int(torch.unique(torch.cat(cells)).numel())
    inputs = (slots.numel() * 4 + vals.numel() * 4 + flags.numel() * 4
              + K * 4 + table.numel() * 4)
    cleared = Bn * n * n * K * 4
    return inputs + cleared + touched * 8


def phase_kernel(results: dict) -> None:
    import torch
    from repro_torch.core import channel as ch
    from repro_torch.kernels.channel_ring import kernel, ops, ref

    n = 5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0.0
    for name, (spec, names) in layouts().items():
        ring_k = ch.make_ring(spec, D, n, B, torch.device("cuda"))
        ring_r = {"buf": ring_k["buf"].clone()}
        for t in range(2 * D):
            sends, drop = random_sends(spec, names, n, gen, ch)
            ring_k = ch.ring_commit(spec, ring_k, t, sends, drop=drop,
                                    backend="cuda")
            ring_r = ch.ring_commit(spec, ring_r, t, sends, drop=drop,
                                    backend="ref")
            if not torch.equal(ring_k["buf"], ring_r["buf"]):
                diff = (ring_k["buf"] - ring_r["buf"]).abs().max().item()
                raise AssertionError(f"{name}: kernel != plain at tick {t} "
                                     f"(max abs diff {diff})")
        max_err = max(max_err, (ring_k["buf"] - ring_r["buf"]).abs()
                      .max().item())
        log("kernel", f"{name}: K={spec.k} E={len(names)} B={B} D={D}, "
                      f"{2 * D} ticks, kernel == plain bitwise after every "
                      "tick")

    per_layout = {}
    for name in ("sporades", "mandator"):
        spec, names = layouts()[name]
        ring = ch.make_ring(spec, D, n, B, torch.device("cuda"))
        sends, drop = random_sends(spec, names, n, gen, ch)
        t = 3
        entries, lay = ch.commit_entries(spec, D, t, sends, drop)
        lay = ref.as_layout(lay)
        slots, vals, flags = ops.pack_entries(entries)
        table = ops.layout_table(lay, torch.device("cuda"))
        fill = ch.fill_tensor(spec, torch.device("cuda"))
        buf_k, buf_r = ring["buf"].clone(), ring["buf"].clone()
        ms = device_ms(lambda: kernel.ring_commit_cuda(
            buf_k, t, fill, slots, vals, flags, table))
        plain_ms = device_ms(lambda: ref.ring_commit_ref(
            buf_r, t, fill, slots, vals, flags, lay))
        err = (buf_k - buf_r).abs().max().item()
        max_err = max(max_err, err)
        nbytes = bound_bytes(buf_k, slots, vals, flags, table, lay)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per_layout[name] = {"ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bytes": nbytes,
                            "K": spec.k, "E": len(names)}
        log("kernel", f"{name} layout at B={B} D={D} K={spec.k} "
                      f"E={len(names)}: kernel {ms:.6f} ms/launch, plain "
                      f"{plain_ms:.6f} ms/call, bound {bound_ms:.6f} ms "
                      f"({nbytes} bytes at 3.35 TB/s), max abs err {err}")
    if max_err != 0.0:
        raise AssertionError(f"kernel differs from plain: {max_err}")
    results["per_layout"] = per_layout
    results["max_abs_err"] = max_err


def phase_main(results: dict) -> None:
    import torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import experiment
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.kernels.channel_ring import kernel

    cfg = SMRConfig()
    spec = SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS)
    torch.cuda.synchronize()
    kernel.launch_count = 0
    t0 = time.perf_counter()
    rows = run_sweep("mandator-sporades", cfg, spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launch_count
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    horizon = experiment.timing_stats()["mandator-sporades"]["horizon"]
    for r in rows:
        log("main", f"rate={r['rate']:.0f} seed={r['seed']} "
                    f"throughput={r['throughput']!r} "
                    f"median_ms={r['median_ms']!r} p99_ms={r['p99_ms']!r} "
                    f"committed={r['committed']!r} "
                    f"async_frac={r['async_frac']!r} views={r['views']}")
    lane_ticks = len(rows) * ticks
    log("main", f"{len(rows)} lanes x {ticks} ticks, n={cfg.n_replicas}, "
                f"D={horizon}: wall {wall!r} s, "
                f"{lane_ticks / wall!r} lane-ticks/s, "
                f"{wall / ticks * 1e3!r} ms/tick, "
                f"channel_ring_commit launches {launches}")
    if launches != 2 * ticks:
        raise AssertionError(f"expected {2 * ticks} kernel launches (one per "
                             f"protocol per tick), got {launches}")
    if horizon != D:
        raise AssertionError(f"expected a {D}-slot ring, got {horizon}")
    for r in rows:
        if not (r["committed"] > 0 and math.isfinite(r["median_ms"])):
            raise AssertionError(f"point {r['rate']}/{r['seed']} committed "
                                 "nothing")
        if r["throughput"] > 1.05 * r["rate"]:
            raise AssertionError(f"point {r['rate']}/{r['seed']} exceeds its "
                                 f"offered rate: {r['throughput']}")
        if r["rate"] == 50_000 and abs(r["throughput"] - 50_000) > 5_000:
            raise AssertionError(f"50k tx/s point off by more than 10%: "
                                 f"{r['throughput']}")
    results["launches"] = launches
    results["wall_s"] = wall


def _clone(tree):
    """Deep copy of a (nested) dict of tensors: the tick updates the rings
    in place."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def phase_profile(results: dict) -> None:
    """Where a tick's time goes at the Fig-6 shape: the 16-lane grid is
    stepped to tick 500, then ticks 500-700 run twice from the same state,
    once untraced (wall time, synchronized on both sides) and once under
    torch.profiler. The device's busy share is the traced kernel time over
    the untraced wall time of the same window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import experiment, harness, workload
    from repro_torch.core.experiment import SweepSpec

    dev = torch.device("cuda")
    spec = SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS)
    _, cfg, _, env, rate_b, seeds = experiment._lower(SMRConfig(), spec, dev)
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    draws = workload.draw_table(rate_b.tolist(), seeds, ticks,
                                cfg.n_replicas, dev)
    carry = harness.init_carry(cfg, ticks, len(seeds), dev)
    for t in range(500):                        # past the warm-up
        carry = harness.step(carry, t, draws, env, cfg)
    window = range(500, 700)
    start = _clone(carry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in window:
        carry = harness.step(carry, t, draws, env, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(window)
    carry = start
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in window:
            carry = harness.step(carry, t, draws, env, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    log("profile", f"ticks 500-700 untraced: {wall_ms!r} ms/tick wall "
                   f"(the whole sweep: {results['wall_s'] / ticks * 1e3!r} "
                   "ms/tick)")
    if dev_us <= 0:
        log("profile", "torch.profiler recorded no device time: device "
                       "busy share not measured")
        return
    per_tick_ms = dev_us / 1e3 / len(window)
    log("profile", f"{len(window)} ticks traced: {launches / len(window)!r} "
                   f"kernel launches/tick, device busy {per_tick_ms!r} "
                   f"ms/tick of {wall_ms!r} ms/tick untraced wall, same "
                   f"window (busy share {per_tick_ms / wall_ms!r})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log("profile", f"  {e.self_device_time_total / len(window)!r} "
                       f"us/tick x{e.count / len(window):g}/tick  "
                       f"{e.key[:90]}")


def phase_whole_path() -> None:
    import dataclasses

    import numpy as np
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.scenarios import library

    sim_s = 2.0
    names = ("baseline", "leader-crash-recover")
    spec = SweepSpec(rates=(100_000,), seeds=(0,),
                     scenarios=tuple(library.get(x, sim_s) for x in names))
    cfg = SMRConfig(sim_seconds=sim_s)
    runs = {b: run_sweep("mandator-sporades",
                         dataclasses.replace(cfg, channel_backend=b), spec)
            for b in ("cuda", "ref")}
    _assert_same(runs["cuda"], runs["ref"], names, "kernel vs plain")
    for r, name in zip(runs["cuda"], names):
        log("whole", f"{name} 2 s @100k: throughput={r['throughput']!r} "
                     f"median_ms={r['median_ms']!r} "
                     f"async_frac={r['async_frac']!r} views={r['views']}")
    if not runs["cuda"][1]["async_frac"] > 0:
        raise AssertionError("leader-crash-recover never entered the async "
                             "path")
    log("whole", "kernel vs plain: cvc_all, commit_key, views, async_frac "
                 "bitwise equal on both scenarios")

    # the card against the CPU path (held to the JAX reference by the
    # repo's tests) on one arrival table
    sim_s = 1.0
    cfg = SMRConfig(sim_seconds=sim_s)
    spec = SweepSpec(rates=(100_000,), seeds=(0,),
                     scenarios=tuple(library.get(x, sim_s) for x in names))
    rng = np.random.RandomState(0)
    draws = rng.poisson(20.0, (2, int(sim_s * 1000), 5)).astype(np.float32)
    gpu = run_sweep("mandator-sporades", cfg, spec, draws=draws)
    cpu = run_sweep("mandator-sporades", cfg, spec, device="cpu",
                    draws=draws)
    _assert_same(gpu, cpu, names, "cuda vs cpu")
    log("whole", "card vs CPU (1 s, one arrival table): cvc_all, "
                 "commit_key, views, async_frac bitwise equal")


def _assert_same(a, b, names, what) -> None:
    import numpy as np
    for x, y, name in zip(a, b, names):
        for k in ("cvc_all", "commit_key"):
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{what}: {name} {k} differs")
        for k in ("views", "async_frac"):
            if x[k] != y[k]:
                raise AssertionError(f"{what}: {name} {k} {x[k]} != {y[k]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels.channel_ring import kernel

    card = card_line()
    log("card", card)
    log("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
                f"device {torch.cuda.get_device_name(0)}")

    built = kernel.build()
    log("build", f"{built.path.name} built in {built.seconds!r} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    results: dict = {}
    phase_kernel(results)
    phase_main(results)
    phase_profile(results)
    phase_whole_path()

    sp = results["per_layout"]["sporades"]
    kernels = [{
        "name": "channel_ring_commit",
        "route": "cuda",
        "source": "src/repro_torch/csrc/channel_ring.cu",
        "replaces": "src/repro/kernels/channel_ring/kernel.py:36",
        "launches": results["launches"],
        "max_abs_err": results["max_abs_err"],
        "ms": sp["ms"],
        "plain_ms": sp["plain_ms"],
        "bound_ms": sp["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "per_layout": results["per_layout"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
