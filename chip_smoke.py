#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

  1. card   — nvidia-smi's name and power limit;
  2. build  — nvcc builds the five kernels of csrc/ (channel_ring.cu,
              rmsnorm.cu, flash_attention.cu, ssm_scan.cu,
              decode_attention.cu; sm_90a), all started together; build
              time and ptxas registers and spills;
  3. kernel — random tick traffic (drops, in-slot collisions, 2*D ticks,
              D=256, B=16) and adversarial traffic (D ticks from a ring
              holding cells below -1 and additive -0.0, expanded payloads,
              most sends masked out) through the sporades, mandator and
              additive ring layouts: the fused commit (one launch that
              reads the sends where they lie) and the plain PyTorch path
              (commit_entries, pack_entries, ring_commit_ref) bit for bit
              equal after every tick; then, in one call, the device time
              (CUDA events) of the fused launch, of commit_entries +
              pack_entries alone (the preparation the launch absorbs) and
              of the plain path, beside the bytes-based bound at 3.35 TB/s,
              and the host time per call of the fused and the plain path;
  4. main   — the Fig-6 sweep at full size through the port's entry point:
              run_sweep("mandator-sporades", SMRConfig(), 4 rates x 4
              seeds) = 16 lanes, n=5, 10 000 ticks, D=256, with the kernel
              on the path (launch counts read around this run only);
  5. profile — ticks 500-700 of that grid run twice from one state,
              untraced (wall per tick) and under torch.profiler (kernel
              launches per tick, device busy time per tick, the top
              kernels);
  6. whole path — 1.5 s runs of baseline and leader-crash-recover with
              the kernel and with the plain version, bitwise equal (2 s
              runs until the model phases were added; 1.5 s still enters
              the async path, as tests/test_torch_slice.py checks); the
              same points for 1 s on the card and on the CPU from one
              arrival table, bitwise equal: the integer traces and every
              float metric (SAME_LEAVES);
  7. model kernels — RMSNorm (RMS_CASES: [8192, 576] and [4, 576],
              float32 and bfloat16, with and without residual, float32 and
              bfloat16 weights; d_model 8192; D = 100; x views off a
              16-byte boundary; each with the kernel's launch plan) and
              flash attention
              (SmolLM-135M's B=4 S=2048 H=9 Kh=3 D=64 causal, a ragged
              S=1000, qwen3-14b's D=128 H=40 Kh=8, a non-causal S=512,
              each in float32 (the 3xTF32 tensor-core kernel) and bfloat16
              (the bf16 tensor-core kernel); each case checks which kernel
              its launch took) against their plain versions, the bf16
              cases also against the kernel's rounding order
              (attention_kernel_order) and the float32 ones against the
              3xTF32 kernel's (attention_tf32x3_order), element by
              element, with the time per launch (CUDA
              events), the bound, the plain version's time and one PyTorch
              library call's (F.rms_norm where w has x's dtype, in float32
              and bfloat16; F.scaled_dot_product_attention); each flash
              case also times the CUDA-core kernel on the same inputs, the
              one that served it before the tensor-core kernels;
  8. prefill — full-width smollm-135m (random weights, seed 0) on tokens
              [4, 2048]: forward_train with the kernels (attention_impl=
              "pallas", use_pallas_norm) and with their plain versions;
              logits' max difference, wall time, tokens/s and the launches
              of each kernel in the kernel run (all 30 flash launches on
              the 3xTF32 kernel);
  9. decode — the same model and prompt token by token through
              forward_decode for the first 256 positions: logits within
              5e-3 of the prefill's at every position, ms per step, and 16
              steps profiled (launches per step, device busy share);
 10. serve  — serve("smollm-135m", reduced=False, batch=4, prompt_len=16,
              gen=32) through the entry point: tokens [4, 32];
 11. ssm kernel — the selective scan against its plain version at the
              Jamba mixer's [2, 2048, 16384, 16], a ragged [1, 1000, 16384,
              16], the reference test's [2, 64, 32, 8] (float32) and the
              mixer's shape with x, dt, B, C in bfloat16: max abs error,
              time per launch (CUDA events, inputs cycled past the L2),
              the bound (bytes, or the pipes' floor) and the plain
              version's time; at the mixer's shape also the time of the
              kernel's copies in and out alone (ssm_scan_loads_cuda,
              uncounted);
 12. decode kernel — flash-decoding through its entry point
              (kernels/decode_attention/ops.py) at SmolLM-135M's decode
              (B=4 H=9 Kh=3 D=64 S=2048, kv_len 256/1000/1777/2048), on the
              reference's [B, Kh, S, D] layout and on the model cache's
              [B, S, Kh, D] as a view (launch counts read around these two
              calls only), then the kernel against its plain version and
              SDPA at that shape and at qwen3-14b's (B=8 H=40 Kh=8 D=128
              S=8192, full and ragged), float32 and bfloat16 (the bf16
              cases also against decode_attention_kernel_order at the
              kernel's split plan), and against the model's chunked kv_len
              route (layers.chunked_attention);
 13. mamba  — the full-width Jamba-1.5-Large Mamba mixer (d_model 8192,
              Di 16384, N 16, 403.6 M parameters, random weights from seed
              0) on x [2, 2048, 8192] float32: mamba_forward with
              use_kernel=True (one ssm_scan launch) and False (the chunked
              scan), their difference, walls and tokens/s, a profile of
              the kernel path; then mamba_decode token by token from a zero
              state for 64 positions against the prefill's outputs;
 14. prefill bf16 — the same smollm-135m and tokens as phase 8 run as the
              reference runs by default: bfloat16 weights and compute
              (init_params(..., dtype=bfloat16), CallConfig(compute_dtype=
              bfloat16, attention_impl="pallas", use_pallas_norm)), so that
              flash attention takes the tensor-core kernel: walls and
              tokens/s with the kernels and with their plain versions,
              exactly 30 flash and 61 RMSNorm launches, the logits of both
              held against a float32 forward of the same weights (the
              kernels' error at most LOGITS_BF16_RATIO times the plain
              path's), and a profile of one forward (kernel launches per
              forward, flash's share of device time);
 15. the card's line, the kernels line, then the result line.

It imports nothing of JAX and nothing of the JAX package. Float32 matrix
products and convolutions run in full float32 (TF32 off).
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
L2_BYTES = 50e6                    # H100 L2 cache (data sheet)
# H100 SXM dense peaks (data sheet): float32 without tensor cores, bf16
# and TF32 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
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


def random_sends(spec, names, n, gen, ch, expand=False, p_mask=0.5):
    """One tick of random traffic: payload uniform in [-1, 50), delays in
    [0, 2D) (clipped to [1, D-1] by the commit, so slots collide), masks
    (on with probability ``p_mask``) and drops at random. With ``expand``
    each payload is one row per sender broadcast to every receiver (stride
    0), and the sends share one delay tensor, as the sporades tick sends
    them."""
    import torch
    def delays():
        return torch.randint(0, 2 * D, (B, n, n), generator=gen,
                             device="cuda", dtype=torch.int32)

    sends = []
    shared = delays() if expand else None
    for name in names:
        w = spec[name].width
        if expand:
            pay = (torch.rand((B, n, 1, w), generator=gen, device="cuda")
                   * 51 - 1).expand(B, n, n, w)
            delay = shared
        else:
            pay = torch.rand((B, n, n, w), generator=gen,
                             device="cuda") * 51 - 1
            delay = delays()
        mask = torch.rand((B, n, n), generator=gen, device="cuda") < p_mask
        sends.append(ch.Send(name, pay, delay, mask))
    drop = torch.rand((B, n, n), generator=gen, device="cuda") < 0.2
    return sends, drop


def adversarial_ring(spec, n, gen, ch):
    """A ring the simulator never holds, to pin the commit's bitwise
    semantics: every cell uniform in [-3, 2), so that masked-out sends'
    neutral -1 raises the cells below it, and additive payload fields -0.0
    in half of the cells, which an added 0.0 turns into +0.0."""
    import torch
    buf = torch.rand((B, D, n, n, spec.k), generator=gen,
                     device="cuda") * 5 - 3
    for c in spec.channels:
        if c.additive:
            off = spec.offset(c.name)
            neg0 = torch.rand(buf[..., off:off + c.width].shape,
                              generator=gen, device="cuda") < 0.5
            buf[..., off:off + c.width][neg0] = -0.0
    return {"buf": buf}


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


def bound_bytes(buf, t, sends, drop, layout) -> int:
    """Bytes the fused commit must move with these inputs: each send's
    stored elements read once (an expanded view's storage once, a tensor
    that several sends share once), drop and fill read once, the cleared
    slot written once, and each ring cell a send targets read and written
    once (a masked-out send still merges its neutral value)."""
    import torch
    Bn, Dn, n, _, K = buf.shape
    seen, inputs = set(), K * 4
    tensors = [x for s in sends for x in (s.payload, s.delay_ticks, s.mask)]
    for x in tensors + ([drop] if drop is not None else []):
        key = (x.data_ptr(), tuple(x.shape), x.stride())
        if key not in seen:
            seen.add(key)
            inputs += x.element_size() * math.prod(
                size for size, st in zip(x.shape, x.stride()) if st != 0)
    cells = []
    b = torch.arange(Bn, device="cuda").view(Bn, 1, 1)
    ij = torch.arange(n * n, device="cuda").view(1, n, n)
    for s, (off, w, flag_off, _) in zip(sends, layout):
        slot = (t + torch.clamp(s.delay_ticks.long(), 1, Dn - 1)) % Dn
        base = ((b * Dn + slot) * n * n + ij) * K
        keep = slot != t % Dn
        for f in list(range(off, off + w)) + [flag_off]:
            cells.append((base + f)[keep])
    touched = int(torch.unique(torch.cat(cells)).numel())
    cleared = Bn * n * n * K * 4
    return inputs + cleared + touched * 8


def host_ms(fn, calls: int = 200) -> float:
    """Host wall time per call of ``fn`` over ``calls`` calls, the device
    drained before and after: what a tick pays on the host to issue it
    (the device work of these calls is far shorter)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def phase_kernel(results: dict) -> None:
    import torch
    from repro_torch.core import channel as ch
    from repro_torch.kernels.channel_ring import kernel, ops

    n = 5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0.0
    for name, (spec, names) in layouts().items():
        for traffic in ("random", "adversarial"):
            if traffic == "random":
                ring_k = ch.make_ring(spec, D, n, B, torch.device("cuda"))
            else:
                ring_k = adversarial_ring(spec, n, gen, ch)
            ring_r = {"buf": ring_k["buf"].clone()}
            ticks = 2 * D if traffic == "random" else D
            for t in range(ticks):
                # adversarial: expanded payloads, most sends masked out
                sends, drop = random_sends(
                    spec, names, n, gen, ch, expand=traffic != "random"
                    and t % 2 == 0, p_mask=0.5 if traffic == "random"
                    else 0.2)
                ring_k = ch.ring_commit(spec, ring_k, t, sends, drop=drop,
                                        backend="cuda")
                ring_r = ch.ring_commit(spec, ring_r, t, sends, drop=drop,
                                        backend="ref")
                if not torch.equal(ring_k["buf"].view(torch.int32),
                                   ring_r["buf"].view(torch.int32)):
                    diff = (ring_k["buf"] - ring_r["buf"]).abs().max().item()
                    raise AssertionError(f"{name} {traffic}: kernel != "
                                         f"plain at tick {t} (max abs diff "
                                         f"{diff})")
            log("kernel", f"{name} ({traffic}): K={spec.k} E={len(names)} "
                          f"B={B} D={D}, {ticks} ticks, kernel == plain "
                          "bitwise after every tick")

    per_layout = {}
    for name in ("sporades", "mandator"):
        spec, names = layouts()[name]
        ring = ch.make_ring(spec, D, n, B, torch.device("cuda"))
        sends, drop = random_sends(spec, names, n, gen, ch, expand=True)
        t = 3
        layout = ch.send_layout(spec, tuple(names))
        fill = ch.fill_tensor(spec, torch.device("cuda"))
        buf_k, buf_r = ring["buf"].clone(), ring["buf"].clone()
        ring_r = {"buf": buf_r}

        def fused():
            kernel.ring_commit_fused(buf_k, t, fill, sends, drop, layout)

        def prep():
            ops.pack_entries(ch.commit_entries(spec, D, t, sends, drop)[0])

        def plain():
            ch.ring_commit(spec, ring_r, t, sends, drop, backend="ref")

        ms, prep_ms, plain_ms = (device_ms(f) for f in (fused, prep, plain))
        host = {k: host_ms(f) for k, f in (("fused", fused),
                                           ("plain", plain))}
        err = (buf_k - buf_r).abs().max().item()
        max_err = max(max_err, err)
        nbytes = bound_bytes(buf_k, t, sends, drop, layout)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per_layout[name] = {"ms": ms, "prep_ms": prep_ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bytes": nbytes, "host_ms": host,
                            "K": spec.k, "E": len(names)}
        log("kernel", f"{name} layout at B={B} D={D} K={spec.k} "
                      f"E={len(names)}, expanded payloads: fused launch "
                      f"{ms!r} ms; commit_entries + pack_entries alone "
                      f"{prep_ms!r} ms; plain path (those + "
                      f"ring_commit_ref) {plain_ms!r} ms; bound "
                      f"{bound_ms!r} ms ({nbytes} bytes at 3.35 TB/s); "
                      f"host per call fused {host['fused']!r} ms, plain "
                      f"{host['plain']!r} ms; max abs err {err}")
    if max_err != 0.0:
        raise AssertionError(f"kernel differs from plain: {max_err}")
    results["per_layout"] = per_layout
    results["max_abs_err"] = max_err


def phase_main(results: dict) -> None:
    import torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import experiment
    from repro_torch.core.experiment import SweepSpec, run_sweep

    cfg = SMRConfig()
    spec = SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rows = run_sweep("mandator-sporades", cfg, spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()["channel_ring_commit"]
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
    results["profile"] = {"wall_ms_per_tick": wall_ms,
                          "launches_per_tick": launches / len(window),
                          "device_ms_per_tick": per_tick_ms,
                          "busy_share": per_tick_ms / wall_ms}
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

    sim_s = 1.5
    names = ("baseline", "leader-crash-recover")
    spec = SweepSpec(rates=(100_000,), seeds=(0,),
                     scenarios=tuple(library.get(x, sim_s) for x in names))
    cfg = SMRConfig(sim_seconds=sim_s)
    runs = {b: run_sweep("mandator-sporades",
                         dataclasses.replace(cfg, channel_backend=b), spec)
            for b in ("cuda", "ref")}
    _assert_same(runs["cuda"], runs["ref"], names, "kernel vs plain")
    for r, name in zip(runs["cuda"], names):
        log("whole", f"{name} {sim_s} s @100k: "
                     f"throughput={r['throughput']!r} "
                     f"median_ms={r['median_ms']!r} "
                     f"async_frac={r['async_frac']!r} views={r['views']}")
    if not runs["cuda"][1]["async_frac"] > 0:
        raise AssertionError("leader-crash-recover never entered the async "
                             "path")
    log("whole", f"kernel vs plain: {', '.join(SAME_LEAVES)} bitwise equal "
                 "on both scenarios")

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
    log("whole", f"card vs CPU (1 s, one arrival table): "
                 f"{', '.join(SAME_LEAVES)} bitwise equal")


# every leaf of a result row that phase 6 holds bit for bit: the integer
# traces and, since the metric sums are exact (core/harness.py
# _batch_metrics), the float metrics too
SAME_LEAVES = ("cvc_all", "commit_key", "views", "async_frac", "throughput",
               "median_ms", "p99_ms", "committed", "timeline",
               "origin_median_ms", "origin_p99_ms", "origin_timeline",
               "origin_lat_ms_timeline")


def _assert_same(a, b, names, what) -> None:
    """Every leaf of SAME_LEAVES equal bit for bit (floats compared as
    their float32 bits, so NaN equals NaN and -0.0 differs from 0.0)."""
    import numpy as np
    for x, y, name in zip(a, b, names):
        for k in SAME_LEAVES:
            u, v = np.asarray(x[k]), np.asarray(y[k])
            if u.dtype.kind == "f":
                u, v = (t.astype(np.float32).view(np.uint32) for t in (u, v))
            if u.shape != v.shape or not np.array_equal(u, v):
                raise AssertionError(f"{what}: {name} {k} differs: "
                                     f"{x[k]!r} != {y[k]!r}")


# ---------------------------------------------------------------------------
# the model stack: RMSNorm and flash attention kernels, prefill, decode
# ---------------------------------------------------------------------------

# (rows, D, dtype, residual, w dtype, x offset in elements): the B=4 x
# S=2048 prefill and a B=4 decode step of smollm-135m, with float32 and
# with bfloat16 weights (the bf16 model keeps its norm weights in bf16);
# Jamba's and qwen1.5-110b's d_model 8192 (a [2, 2048] prefill and a
# decode step); a D of 100, which no 16-byte vector of bf16 divides; and x
# views that start 4 and 6 bytes past a 16-byte boundary
RMS_CASES = tuple((n, 576, dt, res, "float32", 0) for n in (8192, 4)
                  for dt in ("float32", "bfloat16") for res in (False, True)
                  ) + tuple((n, 576, "bfloat16", res, "bfloat16", 0)
                            for n in (8192, 4) for res in (False, True)) + (
    (4096, 8192, "float32", False, "float32", 0),
    (4, 8192, "bfloat16", True, "bfloat16", 0),
    (1000, 100, "bfloat16", False, "bfloat16", 0),
    (3, 100, "float32", True, "float32", 0),
    (8192, 576, "float32", False, "float32", 1),
    (4, 576, "bfloat16", True, "bfloat16", 3),
)
RMS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# (name, B, S, H, Kh, D, causal, dtype); at D 64 and 128 the bfloat16
# cases run the bf16 tensor-core kernel, the float32 ones the 3xTF32
# tensor-core kernel
FLASH_CASES = (
    ("smollm-prefill", 4, 2048, 9, 3, 64, True, "float32"),
    ("smollm-prefill-bf16", 4, 2048, 9, 3, 64, True, "bfloat16"),
    ("ragged-S1000", 4, 1000, 9, 3, 64, True, "float32"),
    ("qwen3-14b-D128", 1, 2048, 40, 8, 128, True, "float32"),
    ("non-causal", 4, 512, 9, 3, 64, False, "float32"),
    ("qwen3-14b-D128-bf16", 1, 2048, 40, 8, 128, True, "bfloat16"),
    ("ragged-S1000-bf16", 4, 1000, 9, 3, 64, True, "bfloat16"),
    ("non-causal-bf16", 4, 512, 9, 3, 64, False, "bfloat16"),
)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bf16 tensor-core kernel against attention_kernel_order, which rounds P
# where the kernel does, element by element:
#   |out - order| <= FLASH_ORDER_ULPS bf16 ulps of |order|
#                    + FLASH_ORDER_P_FLIP * (softmax(q k^T / sqrt(D)) |v|).
# Both round their float32 result to bf16 once (the ulps). Their float32
# scores differ in the last bits, which can flip the bf16 rounding of a
# p_j by one ulp, 2^-8 of it; were every p_j of a row to flip, its output
# would move by at most 2^-8 * sum_j (p_j / l) |v_j|, which attention_ref
# on |v| gives. A row's limit so follows its own keys: about 2^-8 * 0.8
# for a late causal row of ~1000 N(0, 1) keys, where a dropped key tile
# or a stale ring stage moves the output by ~0.01.
FLASH_ORDER_ULPS = 2
FLASH_ORDER_P_FLIP = 2.0 ** -8
# float32 tensor-core kernel against attention_tf32x3_order (its TF32
# halves, each product step rounded as the tensor cores round into a
# per-block temporary, its key tile), element by element, max abs. What
# the twin leaves out is the kernel's ex2.approx (2 ulp a probability) and
# its order of summing l: about 4x the largest gap read on an H100 (7.2e-7
# at qwen3-14b's D = 128). A kernel that fed its products straight into S
# and O, whose truncation then drifts, was 5e-6 off the oracle, where this
# twin is 5e-7 off it.
TF32X3_ORDER_TOL = 3e-6
PREFILL_B, PREFILL_S, DECODE_STEPS = 4, 2048, 256
LOGITS_TOL = 1e-3        # prefill logits, kernels vs plain, float32
# bf16 prefill: the kernels' logits and the plain versions' are each held
# against a float32 forward of the same (bf16-valued) weights and tokens;
# the kernels' max and mean abs error may be at most this many times the
# plain path's. Both round every activation to bf16; the kernels round in
# another order (flash: P per 128-key tile; RMSNorm: its sum)
LOGITS_BF16_RATIO = 1.5
DECODE_TOL = 5e-3        # decode vs prefill logits (tests/test_models.py)


def check_rmsnorm(n, d, dtype, residual, w_dtype="float32", offset=0):
    """Kernel against plain version on one case: x (and the residual)
    ~ N(0, 1) in ``dtype``, x a view ``offset`` elements into its storage,
    w = 1 + N(0, 0.1^2) in ``w_dtype``, as the model keeps its norm
    weights. Returns (max abs err, inputs)."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn((n * d + offset,), generator=gen, device="cuda").to(dt)
    x = x[offset:].view(n, d)
    r = (torch.randn((n, d), generator=gen, device="cuda").to(dt)
         if residual else None)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(
        getattr(torch, w_dtype))
    out = kernel.rmsnorm_cuda(x, w, eps=1e-5, residual=r)
    want = ref.rmsnorm_ref(x, w, eps=1e-5, residual=r)
    torch.cuda.synchronize()
    if out.dtype != x.dtype or out.shape != x.shape:
        raise AssertionError(f"rmsnorm output {out.dtype} {out.shape}")
    return (out.float() - want.float()).abs().max().item(), (x, w, r)


def order_excess(out, order, spread) -> float:
    """The largest |out - order| in units of its limit, FLASH_ORDER_ULPS
    bf16 ulps of |order| + FLASH_ORDER_P_FLIP * ``spread`` (softmax(q k^T)
    |v| in float32): the kernel passes at <= 1."""
    import torch
    want = order.float()
    mag = want.abs()
    _, e = torch.frexp(mag)            # mag in [2^(e-1), 2^e): ulp 2^(e-8)
    ulp = torch.where(mag > 0, torch.exp2((e - 8).float()),
                      torch.zeros_like(mag))
    lim = FLASH_ORDER_ULPS * ulp + FLASH_ORDER_P_FLIP * spread.float()
    return ((out.float() - want).abs() / lim.clamp_min(2.0 ** -40)
            ).max().item()


def check_flash(b, s, h, kh, d, causal, dtype):
    """Kernel against plain version on one case, q, k, v ~ N(0, 1) in
    ``dtype``. Returns (max abs err vs attention_ref, max abs err vs the
    kernel's rounding twin (attention_kernel_order in bfloat16,
    attention_tf32x3_order for the float32 tensor-core kernel, else None)
    and, in bfloat16, its order_excess (else None), inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    route = kernel.route_for(dt, d)
    before = kernel.route_counts[route]
    out = kernel.flash_attention_cuda(q, k, v, causal=causal)
    if kernel.route_counts[route] != before + 1:
        raise AssertionError(f"flash {dtype} D={d} did not launch the "
                             f"{route} kernel: {kernel.route_counts}")
    want = ref.attention_ref(q, k, v, causal=causal)
    order = None
    if dt == torch.bfloat16:
        order = ref.attention_kernel_order(q, k, v, causal=causal,
                                           block_k=kernel.TC_BLOCK_K)
    elif route == "tf32":
        order = ref.attention_tf32x3_order(
            q, k, v, causal=causal, block_k=kernel.tf32_block_k(d))
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != q.shape:
        raise AssertionError(f"flash output {out.dtype} {out.shape}")
    err = (out.float() - want.float()).abs().max().item()
    order_err = excess = None
    if order is not None:
        order_err = (out.float() - order.float()).abs().max().item()
    if dt == torch.bfloat16:
        spread = ref.attention_ref(q.float(), k.float(), v.float().abs(),
                                   causal=causal)
        excess = order_excess(out, order, spread)
    return err, order_err, excess, (q, k, v)


def flash_cuda_core(q, k, v, causal):
    """The CUDA-core kernel on these inputs (before the tensor-core kernels
    it served every dtype and head dim), launched through the library
    directly so that it is not counted."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    out = torch.empty_like(q)
    b, sq, h, d = q.shape
    err = fk.build().lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        k.shape[1], h, k.shape[2], d, int(causal), 1.0 / math.sqrt(d),
        fk.DTYPES[q.dtype], torch.cuda.current_device(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_launch failed: {err}")
    return out


def flash_bound(b, s, h, kh, d, causal, dtype):
    """(bound ms, what bounds it, flops, bytes): 4*D flops for each visible
    (query, key) pair at the dtype's peak; q, k, v read and out written
    once at 3.35 TB/s. Float32 at D 64 and 128 runs on the tensor cores in
    3xTF32: three TF32 products for each, at the TF32 peak (the least time
    for float32-accurate products on this card)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * b * h * pairs
    es = 4 if dtype == "float32" else 2
    nbytes = es * b * s * d * (2 * h + 2 * kh)
    if dtype == "float32" and d in (64, 128):
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes
    return t_bytes, "bytes", flops, nbytes


def cycling(fn, first: tuple, nbytes: int):
    """A call of ``fn`` that takes the next of enough copies of its inputs
    (``first`` and clones of it) to stream more than three L2 caches'
    worth, so that a timed run of launches reads its inputs from device
    memory as the bound assumes, not from L2. Inputs under 1 MB are not
    copied: a decode step finds them in L2 as well."""
    import itertools

    import torch

    def clone(t):
        """A copy at the same storage offset (so an unaligned view stays
        unaligned)."""
        if t is None or t.storage_offset() == 0:
            return None if t is None else t.clone()
        base = torch.empty(t.storage_offset() + t.numel(), dtype=t.dtype,
                           device=t.device)
        return base[t.storage_offset():].view(t.shape).copy_(t)

    copies = 1 if nbytes < 1e6 else min(8, math.ceil(3 * L2_BYTES / nbytes))
    sets = [first] + [tuple(clone(t) for t in first)
                      for _ in range(copies - 1)]
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def phase_model_kernels(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rref

    cases = []
    for n, d, dtype, residual, w_dtype, offset in RMS_CASES:
        what = (f"rmsnorm [{n}, {d}] {dtype} residual={residual} w "
                f"{w_dtype}" + (f" x offset {offset}" if offset else ""))
        err, (x, w, r) = check_rmsnorm(n, d, dtype, residual, w_dtype,
                                       offset)
        if not err <= RMS_TOL[dtype]:
            raise AssertionError(f"{what}: kernel vs plain {err} > "
                                 f"{RMS_TOL[dtype]}")
        es = x.element_size()
        nbytes = n * d * es * (3 if residual else 2) + d * w.element_size()
        ms = device_ms(cycling(lambda x, w, r: rk.rmsnorm_cuda(
            x, w, residual=r), (x, w, r), nbytes))
        plain_ms = device_ms(cycling(lambda x, w, r: rref.rmsnorm_ref(
            x, w, residual=r), (x, w, r), nbytes))
        library_ms = None
        if not residual and w.dtype == x.dtype:
            library_ms = device_ms(cycling(lambda x, w, _: F.rms_norm(
                x, (d,), w, 1e-5), (x, w, r), nbytes))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        vb = rk.vector_bytes(d, *(t for t in (x, x, r, w) if t is not None))
        plan = rk.plan(n, d, x.dtype, vb)._asdict()
        cases.append({"shape": [n, d], "dtype": dtype, "residual": residual,
                      "w_dtype": w_dtype, "x_offset": offset,
                      "plan": plan, "max_abs_err": err,
                      "tol": RMS_TOL[dtype], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bytes": nbytes, "library_ms": library_ms})
        log("model kernels", f"{what}: plan {plan}, max abs err {err!r} "
                             f"(tol {RMS_TOL[dtype]}), kernel {ms!r} ms, "
                             f"plain {plain_ms!r} ms, F.rms_norm "
                             f"{library_ms!r} ms, bound {bound_ms!r} ms "
                             f"({nbytes} bytes)")
    results["rmsnorm"] = cases

    cases = []
    for name, b, s, h, kh, d, causal, dtype in FLASH_CASES:
        err, order_err, excess, (q, k, v) = check_flash(b, s, h, kh, d,
                                                        causal, dtype)
        if not err <= FLASH_TOL[dtype]:
            raise AssertionError(f"flash {name}: kernel vs plain {err} > "
                                 f"{FLASH_TOL[dtype]}")
        if excess is not None and not excess <= 1:
            raise AssertionError(f"flash {name}: kernel vs kernel order "
                                 f"{excess} times its limit "
                                 f"({FLASH_ORDER_ULPS} ulps + "
                                 f"{FLASH_ORDER_P_FLIP} P|V|), max abs "
                                 f"{order_err}")
        if (dtype == "float32" and order_err is not None
                and not order_err <= TF32X3_ORDER_TOL):
            raise AssertionError(f"flash {name}: kernel vs "
                                 f"attention_tf32x3_order {order_err} > "
                                 f"{TF32X3_ORDER_TOL}")
        bound_ms, bound_by, flops, nbytes = flash_bound(b, s, h, kh, d,
                                                        causal, dtype)
        ms = device_ms(cycling(lambda q, k, v: fk.flash_attention_cuda(
            q, k, v, causal=causal), (q, k, v), nbytes), reps=10, rounds=5)
        plain_ms = device_ms(cycling(lambda q, k, v: fref.attention_ref(
            q, k, v, causal=causal), (q, k, v), nbytes), reps=3, rounds=3)
        library_ms = device_ms(cycling(
            lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True), (q, k, v), nbytes),
            reps=10, rounds=5)
        route = fk.route_for(q.dtype, d)
        core_ms = core_err = None
        if route != "cuda_core":      # a tensor-core kernel ran
            core_err = (flash_cuda_core(q, k, v, causal).float() - fref
                        .attention_ref(q, k, v, causal=causal).float()
                        ).abs().max().item()
            if not core_err <= FLASH_TOL[dtype]:
                raise AssertionError(f"flash {name}: CUDA-core kernel vs "
                                     f"plain {core_err}")
            core_ms = device_ms(cycling(lambda q, k, v: flash_cuda_core(
                q, k, v, causal), (q, k, v), nbytes), reps=3, rounds=3)
        cases.append({"case": name, "shape": [b, s, h, kh, d],
                      "causal": causal, "dtype": dtype, "max_abs_err": err,
                      "tol": FLASH_TOL[dtype], "order_err": order_err,
                      "order_excess": excess, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "flops": flops, "bytes": nbytes, "flash_kernel": route,
                      "bound_ms_cuda_core":
                          flops / PEAK_FLOPS["float32"] * 1e3,
                      "cuda_core_ms": core_ms, "cuda_core_err": core_err})
        log("model kernels", f"flash {name} B={b} S={s} H={h} Kh={kh} D={d}"
                             f" causal={causal} {dtype} ({route}): max abs "
                             f"err {err!r} (tol {FLASH_TOL[dtype]}), vs "
                             f"kernel order {order_err!r} ({excess!r} of its "
                             f"limit), kernel "
                             f"{ms!r} ms ({flops / ms / 1e9!r} TFLOP/s), "
                             f"plain {plain_ms!r} ms, sdpa {library_ms!r} "
                             f"ms, bound {bound_ms!r} ms by {bound_by}; "
                             f"CUDA-core kernel {core_ms!r} ms (max abs "
                             f"err {core_err!r})")
        del q, k, v
        torch.cuda.empty_cache()
    results["flash"] = cases


def _smollm(dtype: str = "float32"):
    """(cfg, params, tokens, call): full-width smollm-135m with random
    weights from seed 0 and tokens [4, 2048], weights and compute in
    ``dtype`` (bfloat16 is the reference's default), the kernels on."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import CallConfig, init_params
    dt = getattr(torch, dtype)
    cfg = get_config("smollm-135m")
    params = init_params(cfg, 0, dtype=dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    call = CallConfig(compute_dtype=dt, attention_impl="pallas",
                      use_pallas_norm=True, remat=False)
    return cfg, params, tokens, call


def _kernel_modules() -> dict:
    """The kernels' wrapper modules, by the name the kernels line uses."""
    from repro_torch.kernels.channel_ring import kernel as ck
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.ssm_scan import kernel as sk
    return {"channel_ring_commit": ck, "rmsnorm": rk, "flash_attention": fk,
            "ssm_scan": sk, "decode_attention": dk}


def _reset_counts():
    for k in _kernel_modules().values():
        if hasattr(k, "route_counts"):    # flash: launch_count is their sum
            k.route_counts.update(dict.fromkeys(k.route_counts, 0))
        else:
            k.launch_count = 0


def _counts() -> dict:
    return {name: k.launch_count for name, k in _kernel_modules().items()}


def phase_prefill(results: dict, model) -> None:
    import dataclasses

    import torch
    from repro_torch.models import forward_train, param_count_actual

    from repro_torch.kernels.flash_attention import kernel as fk

    cfg, params, tokens, call = model
    plain = dataclasses.replace(call, kernel_backend="ref")
    batch = {"tokens": tokens}
    with torch.no_grad():
        forward_train(params, cfg, call, batch)          # first calls
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        logits, _ = forward_train(params, cfg, call, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        routes = dict(fk.route_counts)
        t0 = time.perf_counter()
        logits_plain, _ = forward_train(params, cfg, plain, batch)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
    diff = (logits - logits_plain).abs().max().item()
    del logits_plain
    n_tok = PREFILL_B * PREFILL_S
    log("prefill", f"{cfg.name} full width ({param_count_actual(params)} "
                   f"params, {cfg.n_layers} layers), tokens "
                   f"[{PREFILL_B}, {PREFILL_S}], float32: kernels "
                   f"{wall!r} s = {n_tok / wall!r} tokens/s; plain "
                   f"versions {wall_plain!r} s = {n_tok / wall_plain!r} "
                   f"tokens/s; logits max abs diff {diff!r} (tol "
                   f"{LOGITS_TOL}); launches {counts}, flash by kernel "
                   f"{routes}")
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite")
    if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab):
        raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
    if not diff <= LOGITS_TOL:
        raise AssertionError(f"prefill logits, kernels vs plain: {diff}")
    want_rms = 2 * cfg.n_layers + 1
    if counts["flash_attention"] != cfg.n_layers \
            or counts["rmsnorm"] != want_rms:
        raise AssertionError(f"expected {cfg.n_layers} flash and "
                             f"{want_rms} rmsnorm launches, got {counts}")
    if routes["tf32"] != cfg.n_layers:
        raise AssertionError(f"expected every flash launch of the float32 "
                             f"prefill on the 3xTF32 kernel, got {routes}")
    results["prefill"] = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                          "plain_wall_s": wall_plain, "logits_diff": diff,
                          "launches": counts, "flash_routes": routes}
    results["prefill_logits"] = logits


def phase_prefill_bf16(results: dict) -> None:
    """The bf16 prefill: kernels against plain versions, each held against
    a float32 forward of the same weights, wall and tokens/s of each (three
    timed runs, median), launches, and a profile of one forward with flash
    attention's share of device time."""
    import copy
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward_train

    cfg, params, tokens, call = _smollm("bfloat16")
    plain = dataclasses.replace(call, kernel_backend="ref")
    batch = {"tokens": tokens}
    with torch.no_grad():                # the float32 yardstick
        exact, _ = forward_train(
            copy.deepcopy(params).float(), cfg,
            dataclasses.replace(plain, compute_dtype=torch.float32), batch)

    def wall(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = forward_train(params, cfg, c, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    with torch.no_grad():
        forward_train(params, cfg, call, batch)          # first calls
        forward_train(params, cfg, plain, batch)
        torch.cuda.synchronize()
        _reset_counts()
        walls = [wall(call)[0]]
        counts = _counts()
        walls += [wall(call)[0] for _ in range(2)]
        plain_walls = [wall(plain)[0] for _ in range(3)]
        _, logits = wall(call)
        _, logits_plain = wall(plain)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward_train(params, cfg, call, batch)
            torch.cuda.synchronize()
    diff = (logits.float() - logits_plain.float()).abs().max().item()
    scale = exact.abs().max().item()
    errs = {}
    for name, out in (("kernels", logits), ("plain", logits_plain)):
        e = (out.float() - exact).abs()
        errs[name] = {"max": e.max().item(), "mean": e.mean().item()}
        del e
    del logits_plain, exact
    n_tok = PREFILL_B * PREFILL_S
    w, wp = statistics.median(walls), statistics.median(plain_walls)
    log("prefill bf16", f"{cfg.name} full width, bf16 weights and compute, "
                        f"tokens [{PREFILL_B}, {PREFILL_S}]: kernels "
                        f"{walls!r} s, median {w!r} s = {n_tok / w!r} "
                        f"tokens/s; plain versions {plain_walls!r} s, "
                        f"median {wp!r} s = {n_tok / wp!r} tokens/s; logits "
                        f"vs a float32 forward (max |logit| {scale!r}): "
                        f"kernels {errs['kernels']}, plain {errs['plain']} "
                        f"(ratio at most {LOGITS_BF16_RATIO}); kernels vs "
                        f"plain max abs {diff!r}; launches {counts}")
    if not torch.isfinite(logits).all():
        raise AssertionError("bf16 prefill logits are not finite")
    if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab):
        raise AssertionError(f"bf16 prefill logits shape "
                             f"{tuple(logits.shape)}")
    for stat in ("max", "mean"):
        if not errs["kernels"][stat] <= \
                LOGITS_BF16_RATIO * errs["plain"][stat]:
            raise AssertionError(f"bf16 prefill logits: the kernels' {stat} "
                                 f"error vs float32 {errs['kernels'][stat]}"
                                 f" > {LOGITS_BF16_RATIO} x the plain "
                                 f"path's {errs['plain'][stat]}")
    want_rms = 2 * cfg.n_layers + 1
    if counts["flash_attention"] != cfg.n_layers \
            or counts["rmsnorm"] != want_rms:
        raise AssertionError(f"expected {cfg.n_layers} flash and "
                             f"{want_rms} rmsnorm launches, got {counts}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_tc_kernel" in e.key) / 1e3
    # the profile is whole only if it kept every launch of the kernels
    seen = {name: sum(e.count for e in kernels if name in e.key)
            for name in ("flash_tc_kernel", "rmsnorm_kernel")}
    results["prefill_bf16"] = {
        "wall_s": w, "walls_s": walls, "tokens_per_s": n_tok / w,
        "plain_wall_s": wp, "plain_walls_s": plain_walls,
        "logits_diff": diff, "logits_scale": scale,
        "logits_err_vs_f32": errs, "launches": counts,
        "profiled_device_ms": dev_ms, "flash_device_ms": flash_ms,
        "flash_share": flash_ms / dev_ms if dev_ms > 0 else None,
        "launches_per_forward": sum(e.count for e in kernels),
        "profiled_kernel_launches": seen}
    if dev_ms <= 0:
        log("prefill bf16", "torch.profiler recorded no device time: "
                            "flash's share not measured")
        return
    log("prefill bf16", f"one forward profiled: device busy {dev_ms!r} ms, "
                        f"{sum(e.count for e in kernels)} kernel launches; "
                        f"flash_tc_kernel {flash_ms!r} ms (share "
                        f"{flash_ms / dev_ms!r}); launches the profile kept "
                        f"{seen} of {counts['flash_attention']} flash and "
                        f"{counts['rmsnorm']} rmsnorm")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log("prefill bf16", f"  {e.self_device_time_total / 1e3!r} ms "
                            f"x{e.count}  {e.key[:90]}")


def phase_decode(results: dict, model) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward_decode, init_cache

    cfg, params, tokens, call = model
    ref = results.pop("prefill_logits")[:, :DECODE_STEPS]
    cache = init_cache(cfg, PREFILL_B, DECODE_STEPS, torch.float32)

    def step(t):
        return forward_decode(params, cfg, call, {"tokens": tokens[:, t]},
                              cache, t)[0]

    torch.cuda.synchronize()
    _reset_counts()
    errs = []
    t0 = time.perf_counter()
    for t in range(DECODE_STEPS):
        errs.append((step(t) - ref[:, t]).abs().max())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    errs = torch.stack(errs)
    worst = errs.max().item()
    ms_step = wall / DECODE_STEPS * 1e3
    log("decode", f"{DECODE_STEPS} steps of B={PREFILL_B}: {ms_step!r} "
                  f"ms/step ({PREFILL_B * 1e3 / ms_step!r} tokens/s); "
                  f"logits vs prefill max abs diff {worst!r} (tol "
                  f"{DECODE_TOL}), worst at position "
                  f"{int(errs.argmax())}; launches {counts}")
    if not worst <= DECODE_TOL:
        raise AssertionError(f"decode logits off the prefill's: {worst}")
    want_rms = (2 * cfg.n_layers + 1) * DECODE_STEPS
    if counts["rmsnorm"] != want_rms or counts["flash_attention"] != 0:
        raise AssertionError(f"expected {want_rms} rmsnorm and no flash "
                             f"launches in decode, got {counts}")

    # positions 240-255 again (the cache already holds them; the mask at
    # kv_len = t + 1 makes each step see what it saw the first time)
    window = range(DECODE_STEPS - 16, DECODE_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in window:
        step(t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(window)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in window:
            step(t)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / len(window)
    launches = sum(e.count for e in kernels) / len(window)
    results["decode"] = {"ms_per_step": ms_step, "max_diff": worst,
                         "launches": counts, "window_ms": wall_ms}
    log("decode", f"steps {window.start}-{window.stop - 1} untraced: "
                  f"{wall_ms!r} ms/step")
    if dev_ms <= 0:
        log("decode", "torch.profiler recorded no device time: device busy "
                      "share not measured")
        return
    results["decode"].update(launches_per_step=launches,
                             device_ms_per_step=dev_ms,
                             busy_share=dev_ms / wall_ms)
    log("decode", f"{len(window)} steps traced: {launches!r} kernel "
                  f"launches/step, device busy {dev_ms!r} ms/step of "
                  f"{wall_ms!r} ms/step untraced wall (busy share "
                  f"{dev_ms / wall_ms!r})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log("decode", f"  {e.self_device_time_total / len(window)!r} "
                      f"us/step x{e.count / len(window):g}/step  "
                      f"{e.key[:90]}")


def phase_serve(results: dict) -> None:
    from repro_torch.launch.serve import serve
    out = serve("smollm-135m", reduced=False, batch=4, prompt_len=16,
                gen=32, verbose=False)
    toks = out["tokens"]
    log("serve", f"smollm-135m full width, batch 4, prompt 16, gen 32: "
                 f"{out['seconds']!r} s, tokens {toks.shape}, first "
                 f"sequence {toks[0, :16].tolist()}")
    if toks.shape != (4, 32) or not ((toks >= 0) & (toks < 49152)).all():
        raise AssertionError(f"serve returned {toks.shape} {toks.dtype}")
    results["serve_s"] = out["seconds"]


# ---------------------------------------------------------------------------
# slice 3: the selective scan, flash-decoding, the full-width Mamba mixer
# ---------------------------------------------------------------------------

# (name, B, S, Di, N, dtype)
SSM_CASES = (
    ("jamba-mixer", 2, 2048, 16384, 16, "float32"),
    ("ragged-S1000", 1, 1000, 16384, 16, "float32"),
    ("reference-test", 2, 64, 32, 8, "float32"),
    ("jamba-mixer-bf16", 2, 2048, 16384, 16, "bfloat16"),
)
# the reference's 1e-4 (tests/test_kernels.py); in bf16 the kernel rounds
# y + D*x once and the plain version rounds y, then adds D*x in float32:
# they differ by up to a bf16 ulp of the output, 2^-7 below 1 and 2^-6
# below 2 (the mixer's outputs stay below 4)
SSM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MIXER_DI_N = (16384, 16)            # the Jamba mixer's Di and N
SMS, CLOCK_HZ = 132, 1.98e9         # H100 SXM: SMs, boost clock
SFU_EXP_PER_S = SMS * 16 * CLOCK_HZ  # 16 MUFU.EX2 a clock per SM
SSM_FP32_OPS = 4                    # float32 operations per scan element
SMOLLM_LENS = (256, 1000, 1777, 2048)
QWEN_LENS = (1, 333, 1024, 2900, 4097, 5555, 7000, 8191)
# (name, B, H, Kh, D, S, kv_len (None: full), dtype, max abs tolerance).
# float32: the reference's 5e-6 (tests/test_kernels.py, S <= 512) up to
# S = 2048; at S = 8192 the kernel and the plain version add 4x as many
# terms of l and acc in different orders, and their rounding grows with
# the square root of the count: 2x, 1e-5. bfloat16: the plain version
# rounds the scores and the probabilities to bf16, the kernel keeps them
# float32, and both round the output once; each case is held at about 4x
# the gap read on an H100 (2^-9 at SmolLM's shape and at qwen3-14b's
# ragged kv_len, where SDPA is 2^-8 off the plain version; 2^-11 at its
# full cache, where the outputs, means of ~3 000 keys, lie below 0.1 and a
# dropped S-split moves them by ~0.02)
DECODE_CASES = (
    ("smollm-decode", 4, 9, 3, 64, 2048, SMOLLM_LENS, "float32", 5e-6),
    ("smollm-decode-bf16", 4, 9, 3, 64, 2048, SMOLLM_LENS, "bfloat16",
     8e-3),
    ("qwen3-14b-full", 8, 40, 8, 128, 8192, None, "float32", 1e-5),
    ("qwen3-14b-full-bf16", 8, 40, 8, 128, 8192, None, "bfloat16", 4e-3),
    ("qwen3-14b-ragged", 8, 40, 8, 128, 8192, QWEN_LENS, "float32", 1e-5),
    ("qwen3-14b-ragged-bf16", 8, 40, 8, 128, 8192, QWEN_LENS, "bfloat16",
     8e-3))
# bf16 decode kernel against decode_attention_kernel_order at the
# kernel's split plan: about 4x the largest gap read on an H100 (2^-12 at
# SmolLM's decode and qwen3-14b's ragged kv_len, 2^-13 at its full cache)
DECODE_ORDER_TOL = 1e-3
MAMBA_B, MAMBA_S, MAMBA_DECODE_STEPS = 2, 2048, 64
MAMBA_REL_TOL = 1e-4      # max abs diff / max abs output, float32


def jamba_mixer():
    """(cfg, params, x): the full-width Jamba-1.5-Large Mamba mixer with
    random weights from seed 0, and its input x [2, 2048, 8192] ~ N(0, 1)
    (the scale an RMSNorm before it gives) from the same generator."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("jamba-1.5-large-398b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    p = ssm.init_mamba(cfg, gen, torch.float32, "cuda")
    x = torch.randn((MAMBA_B, MAMBA_S, cfg.d_model), generator=gen,
                    device="cuda")
    return cfg, p, x


def ssm_inputs(b, s, di, n, dtype, seed=0):
    """(x, dt, B, C, A, D) with x, dt, B, C in ``dtype``, A and D float32.
    At the Jamba mixer's Di and N: the values the full-width mixer feeds
    its scan (``ssm.scan_inputs`` of ``jamba_mixer()``'s x[:b, :s]).
    Otherwise the reference test's distributions (tests/test_kernels.py:
    56-62): x ~ N(0, 0.25), dt = softplus(N(-1, 1)), B, C ~ N(0, 1),
    A = -exp(N(0, 0.09)), D ~ N(0, 1)."""
    import torch
    dt = getattr(torch, dtype)
    if (di, n) == MIXER_DI_N:
        from repro_torch.models import ssm
        _, p, x = jamba_mixer()
        with torch.no_grad():
            xc, dtv, B, C, A, _ = ssm.scan_inputs(p, x[:b, :s])
        return (*(t.to(dt).contiguous() for t in (xc, dtv, B, C)), A,
                p.D.detach())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (r(b, s, di) * 0.5).to(dt)
    z = r(b, s, di) - 1
    dtv = torch.logaddexp(z, torch.zeros_like(z)).to(dt)
    B, C = r(b, s, n).to(dt), r(b, s, n).to(dt)
    A = -torch.exp(r(di, n) * 0.3)
    D = r(di)
    return x, dtv, B, C, A, D


def check_ssm(b, s, di, n, dtype):
    """Kernel against plain version on one case. Returns (max abs err,
    inputs)."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel, ref
    inputs = ssm_inputs(b, s, di, n, dtype)
    out = kernel.ssm_scan_cuda(*inputs)
    want = ref.ssm_scan_ref(*inputs)
    torch.cuda.synchronize()
    if out.dtype != inputs[0].dtype or out.shape != inputs[0].shape:
        raise AssertionError(f"ssm_scan output {out.dtype} {out.shape}")
    return (out.float() - want.float()).abs().max().item(), inputs


def ssm_order_excess(out, inputs) -> float:
    """The largest |out - ssm_scan_kernel_order| in units of its limit, one
    bf16 ulp of the twin's output + 2^-12: both add D x in float32 before
    one cast to bf16, and their float32 values differ by rounding (the
    order of the sums, ex2.approx), which can flip that cast by an ulp
    (2^-12: the float32 gap near zero, where an ulp is small). The kernel
    passes at <= 1. (ssm_scan_ref casts y before adding D x: it is within
    SSM_TOL["bfloat16"] only where the outputs stay small, as the mixer's
    do.)"""
    import torch
    from repro_torch.kernels.ssm_scan import ref
    order = ref.ssm_scan_kernel_order(*inputs).float()
    mag = order.abs()
    _, e = torch.frexp(mag)            # mag in [2^(e-1), 2^e): ulp 2^(e-8)
    ulp = torch.where(mag > 0, torch.exp2((e - 8).float()),
                      torch.zeros_like(mag))
    return ((out.float() - order).abs() / (ulp + 2.0 ** -12)).max().item()


def ssm_bound(b, s, di, n, dtype):
    """(bound ms, what bounds it, flops, bytes, exp ms, pipes ms): x and dt
    read and y written once, B, C, A, D read once, at 3.35 TB/s; and the
    pipes. Per (step, channel, state) the scan does SSM_FP32_OPS float32
    operations (dt*A, (dt*x)*B, the fma into h, the fma of h*C into y) and
    one exponential. The special-function units do 16 exponentials a
    clock per SM (exp ms: all of them there); the FP32 pipe does 128
    operations a clock, and a polynomial exp2 moves an exponential there
    for c = 10 of them (Cody-Waite reduction, a degree-6 Horner
    polynomial, the exponent by integer add). With the best share of the
    exponentials on each, the pipes need elements x (4 + c) / (16 (8 + c))
    clocks per SM (pipes ms, at the 1.98 GHz boost clock). flops counts
    the float32 operations (4 per element, 3 per (step, channel)) for the
    line."""
    es = 4 if dtype == "float32" else 2
    nbytes = es * (3 * b * s * di + 2 * b * s * n) + 4 * (di * n + di)
    elements = b * s * di * n
    flops = SSM_FP32_OPS * elements + 3 * b * s * di
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    exp_ms = elements / SFU_EXP_PER_S * 1e3
    c = 10
    clocks = elements * (SSM_FP32_OPS + c) / (16 * (8 + c)) / SMS
    pipes_ms = clocks / CLOCK_HZ * 1e3
    if pipes_ms >= t_bytes:
        return pipes_ms, "operations", flops, nbytes, exp_ms, pipes_ms
    return t_bytes, "bytes", flops, nbytes, exp_ms, pipes_ms


def phase_ssm_kernel(results: dict) -> None:
    import torch
    from repro_torch.kernels.ssm_scan import kernel, ref

    cases = []
    for name, b, s, di, n, dtype in SSM_CASES:
        err, inputs = check_ssm(b, s, di, n, dtype)
        if not err <= SSM_TOL[dtype]:
            raise AssertionError(f"ssm_scan {name}: kernel vs plain {err} > "
                                 f"{SSM_TOL[dtype]}")
        bound_ms, bound_by, flops, nbytes, exp_ms, pipes_ms = ssm_bound(
            b, s, di, n, dtype)
        ms = device_ms(cycling(kernel.ssm_scan_cuda, inputs, nbytes),
                       reps=10, rounds=5)
        plain_ms = device_ms(cycling(ref.ssm_scan_ref, inputs, nbytes),
                             reps=1, rounds=3)
        # the memory path's share: the kernel's copies alone
        loads_ms = None
        if (di, n) == MIXER_DI_N and s == 2048:
            loads_ms = device_ms(cycling(kernel.ssm_scan_loads_cuda, inputs,
                                         nbytes), reps=10, rounds=5)
        cases.append({"case": name, "shape": [b, s, di, n], "dtype": dtype,
                      "max_abs_err": err, "tol": SSM_TOL[dtype], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "exp_bound_ms": exp_ms,
                      "pipes_bound_ms": pipes_ms,
                      "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "flops": flops, "bytes": nbytes, "library_ms": None,
                      "loads_only_ms": loads_ms})
        log("ssm kernel", f"{name} [{b}, {s}, {di}, {n}] {dtype}: max abs "
                          f"err {err!r} (tol {SSM_TOL[dtype]}), kernel "
                          f"{ms!r} ms, plain {plain_ms!r} "
                          f"ms, bound {bound_ms!r} ms by {bound_by} "
                          f"({nbytes} bytes; pipes {pipes_ms!r} ms, "
                          f"exponentials on the SFU alone {exp_ms!r} ms; "
                          f"{nbytes / ms / 1e9!r} GB/s); copies alone "
                          f"{loads_ms!r} ms")
        del inputs
        torch.cuda.empty_cache()
    results["ssm"] = cases


def decode_inputs(b, h, kh, d, s, lens, dtype, seed=0):
    """q, k, v ~ N(0, 1) in ``dtype`` (k, v as [B, Kh, S, D]) and kv_len
    (``lens``, or S for every sequence) as int32 on the card."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for shape in ((b, h, d), (b, kh, s, d), (b, kh, s, d)))
    kv_len = torch.tensor(lens if lens is not None else (s,) * b,
                          dtype=torch.int32, device="cuda")
    return q, k, v, kv_len


def check_decode(b, h, kh, d, s, lens, dtype):
    """Kernel against plain version on one case. Returns (max abs err vs
    decode_attention_ref, max abs err vs decode_attention_kernel_order at
    the kernel's split plan (None in float32), inputs)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel, ref
    inputs = decode_inputs(b, h, kh, d, s, lens, dtype)
    out = kernel.decode_attention_cuda(*inputs)
    want = ref.decode_attention_ref(*inputs)
    order = None
    if inputs[0].dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = kernel.bf16_ctas_per_sm(d, 0)
        _, chunk = kernel.bf16_plan(s, b * kh, sms, per_sm)
        order = ref.decode_attention_kernel_order(
            *inputs, chunk=chunk, tile=kernel.BF16_TILE)
    torch.cuda.synchronize()
    if out.dtype != inputs[0].dtype or out.shape != inputs[0].shape:
        raise AssertionError(f"decode output {out.dtype} {out.shape}")
    err = (out.float() - want.float()).abs().max().item()
    order_err = (None if order is None
                 else (out.float() - order.float()).abs().max().item())
    return err, order_err, inputs


def decode_bound(b, h, kh, d, s, lens, dtype):
    """(bound ms, what bounds it, flops, bytes): K and V read up to each
    sequence's kv_len, q read and out written, once, at 3.35 TB/s; 4*D
    flops per (query head, visible key) at the float32 peak (the kernel's
    arithmetic type)."""
    es = 4 if dtype == "float32" else 2
    keys = sum(min(n, s) for n in lens) if lens is not None else b * s
    nbytes = es * (2 * keys * kh * d + 2 * b * h * d) + 4 * b
    flops = 4 * d * (h // kh) * kh * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes
    return t_bytes, "bytes", flops, nbytes


def phase_decode_kernel(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.models.layers import chunked_attention

    # the entry point, on both layouts: these two calls are the path
    _, b, h, kh, d, s, lens, dtype, tol = DECODE_CASES[0]
    q, k, v, kv_len = decode_inputs(b, h, kh, d, s, lens, dtype)
    kc, vc = (t.transpose(1, 2).contiguous() for t in (k, v))   # [B,S,Kh,D]
    torch.cuda.synchronize()
    _reset_counts()
    out = ops.decode_attention(q, k, v, kv_len)
    out_cache = ops.decode_attention(q, kc.transpose(1, 2),
                                     vc.transpose(1, 2), kv_len)
    torch.cuda.synchronize()
    launches = _counts()["decode_attention"]
    want = ref.decode_attention_ref(q, k, v, kv_len)
    chunked = chunked_attention(q[:, None], kc, vc, causal=False, chunk=512,
                                kv_len=kv_len)[:, 0]
    errs = {"entry": (out - want).abs().max().item(),
            "cache_layout": (out_cache - want).abs().max().item(),
            "vs_chunked_route": (out_cache - chunked).abs().max().item()}
    log("decode kernel", f"entry point at smollm-decode: {launches} "
                         f"launches; max abs vs plain {errs['entry']!r} "
                         f"(reference layout), {errs['cache_layout']!r} "
                         f"(cache layout view), vs layers.chunked_attention "
                         f"{errs['vs_chunked_route']!r} (tol {tol})")
    if launches != 2:
        raise AssertionError(f"expected 2 decode_attention launches, got "
                             f"{launches}")
    if not max(errs.values()) <= tol:
        raise AssertionError(f"decode attention entry point: {errs}")
    results["decode_attention_path"] = {"launches": launches, **errs}

    cases = []
    for name, b, h, kh, d, s, lens, dtype, tol in DECODE_CASES:
        err, order_err, (q, k, v, kv_len) = check_decode(b, h, kh, d, s,
                                                         lens, dtype)
        if order_err is not None and not order_err <= DECODE_ORDER_TOL:
            raise AssertionError(f"decode {name}: kernel vs kernel order "
                                 f"{order_err} > {DECODE_ORDER_TOL}")
        valid = (torch.arange(s, device="cuda")[None, :]
                 < kv_len[:, None].long())
        sdpa = F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid[:, None, None, :],
            enable_gqa=True)[:, :, 0]
        want = ref.decode_attention_ref(q, k, v, kv_len)
        sdpa_err = (sdpa.float() - want.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"decode {name}: kernel vs plain {err} > "
                                 f"{tol}")
        bound_ms, bound_by, flops, nbytes = decode_bound(b, h, kh, d, s,
                                                         lens, dtype)
        ms = device_ms(cycling(kernel.decode_attention_cuda,
                               (q, k, v, kv_len), nbytes), reps=20, rounds=5)
        plain_ms = device_ms(cycling(ref.decode_attention_ref,
                                     (q, k, v, kv_len), nbytes),
                             reps=5, rounds=3)
        library_ms = device_ms(cycling(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=m, enable_gqa=True),
            (q, k, v, valid[:, None, None, :]), nbytes), reps=20, rounds=5)
        cases.append({"case": name, "shape": [b, h, kh, d, s],
                      "kv_len": list(lens) if lens else None,
                      "dtype": dtype, "max_abs_err": err, "tol": tol,
                      "order_err": order_err,
                      "order_tol": DECODE_ORDER_TOL if order_err is not None
                      else None,
                      "sdpa_vs_plain": sdpa_err, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "flops": flops, "bytes": nbytes})
        log("decode kernel", f"{name} B={b} H={h} Kh={kh} D={d} S={s} "
                             f"{dtype}: max abs err {err!r} (tol {tol}; "
                             f"sdpa vs plain {sdpa_err!r}; vs kernel order "
                             f"{order_err!r}, tol {DECODE_ORDER_TOL}), "
                             f"kernel {ms!r} "
                             f"ms ({nbytes / ms / 1e9!r} GB/s), plain "
                             f"{plain_ms!r} ms, sdpa {library_ms!r} ms, "
                             f"bound {bound_ms!r} ms by {bound_by} "
                             f"({nbytes} bytes)")
        del q, k, v, kv_len, valid, sdpa, want
        torch.cuda.empty_cache()
    results["decode_attention"] = cases


def phase_mamba(results: dict) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    torch.cuda.reset_peak_memory_stats()
    cfg, p, x = jamba_mixer()
    n_params = sum(t.numel() for t in p.parameters())
    n_tok = MAMBA_B * MAMBA_S

    def fwd(use_kernel):
        return ssm.mamba_forward(p, x, cfg=cfg, use_kernel=use_kernel)

    with torch.no_grad():
        fwd(True)                                   # first calls
        fwd(False)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        y = fwd(True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        t0 = time.perf_counter()
        y_plain = fwd(False)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd(True)
            torch.cuda.synchronize()
    scale = y_plain.abs().max().item()
    diff = (y - y_plain).abs().max().item()
    del y_plain
    matmul_flops = 2 * n_tok * cfg.d_model * 3 * cfg.ssm.expand * cfg.d_model
    log("mamba", f"{cfg.name} mixer full width ({n_params} params: d_model "
                 f"{cfg.d_model}, Di {cfg.ssm.expand * cfg.d_model}, N "
                 f"{cfg.ssm.d_state}), x [{MAMBA_B}, {MAMBA_S}, "
                 f"{cfg.d_model}] float32: use_kernel=True {wall!r} s = "
                 f"{n_tok / wall!r} tokens/s; use_kernel=False (chunked "
                 f"scan) {wall_plain!r} s = {n_tok / wall_plain!r} tokens/s; "
                 f"max abs diff {diff!r}, relative {diff / scale!r} (max "
                 f"|out| {scale!r}; tol {MAMBA_REL_TOL} relative); launches "
                 f"{counts}; peak memory {peak_gb!r} GB; w_in and w_out "
                 f"need {matmul_flops} flop, {matmul_flops / 67e9!r} ms at "
                 "67 TFLOP/s")
    if not torch.isfinite(y).all():
        raise AssertionError("mamba output is not finite")
    if tuple(y.shape) != (MAMBA_B, MAMBA_S, cfg.d_model):
        raise AssertionError(f"mamba output shape {tuple(y.shape)}")
    if not diff <= MAMBA_REL_TOL * scale:
        raise AssertionError(f"mamba kernel vs chunked scan: {diff} of "
                             f"{scale}")
    if counts["ssm_scan"] != 1:
        raise AssertionError(f"expected 1 ssm_scan launch, got {counts}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log("mamba", f"kernel path profiled: device busy {dev_ms!r} ms, "
                 f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log("mamba", f"  {e.self_device_time_total / 1e3!r} ms "
                     f"x{e.count}  {e.key[:90]}")

    state = ssm.mamba_init_state(cfg, MAMBA_B, torch.float32, "cuda")
    errs = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MAMBA_DECODE_STEPS):
            out, state = ssm.mamba_decode(p, x[:, t:t + 1], state, cfg=cfg)
            errs.append((out[:, 0] - y[:, t]).abs().max())
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / MAMBA_DECODE_STEPS
    worst = torch.stack(errs).max().item()
    log("mamba", f"mamba_decode {MAMBA_DECODE_STEPS} steps of B={MAMBA_B} "
                 f"from a zero state: {ms_step!r} ms/step; vs the prefill's "
                 f"outputs max abs diff {worst!r}, relative "
                 f"{worst / scale!r} (tol {MAMBA_REL_TOL} relative)")
    if not worst <= MAMBA_REL_TOL * scale:
        raise AssertionError(f"mamba decode off the prefill: {worst}")
    results["mamba"] = {
        "params": n_params, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "plain_wall_s": wall_plain, "max_abs_diff": diff,
        "rel_diff": diff / scale, "launches": counts,
        "profiled_device_ms": dev_ms, "peak_gb": peak_gb,
        "decode_ms_per_step": ms_step, "decode_max_diff": worst}


def _case(cases: list, name: str) -> dict:
    return next(c for c in cases if c["case"] == name)


def kernel_entries(results: dict) -> list:
    """The kernels line: one entry per kernel."""
    sp = results["per_layout"]["sporades"]
    rms, flash = results["rmsnorm"][0], results["flash"][0]
    ssm, dec = results["ssm"][0], results["decode_attention"][0]
    flash16 = _case(results["flash"], "smollm-prefill-bf16")
    ssm16 = _case(results["ssm"], "jamba-mixer-bf16")
    dec16 = _case(results["decode_attention"], "qwen3-14b-full-bf16")
    return [{
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
        "prep_ms": sp["prep_ms"],
        "per_layout": results["per_layout"],
        "tick_profile": results.get("profile"),
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:15",
        "launches": results["prefill"]["launches"]["rmsnorm"],
        "max_abs_err": rms["max_abs_err"],
        "ms": rms["ms"],
        "plain_ms": rms["plain_ms"],
        "bound_ms": rms["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rms["library_ms"],
        "launches_decode": results["decode"]["launches"]["rmsnorm"],
        "launches_bf16_prefill":
            results["prefill_bf16"]["launches"]["rmsnorm"],
        "cases": results["rmsnorm"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "launches": results["prefill"]["launches"]["flash_attention"],
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "earlier_ms": flash["cuda_core_ms"],
        "bound_ms_cuda_core": flash["bound_ms_cuda_core"],
        "kernel": "flash_tf32_kernel",
        "launches_by_kernel": results["prefill"]["flash_routes"],
        "ms_bf16": flash16["ms"],
        "library_ms_bf16": flash16["library_ms"],
        "bound_ms_bf16": flash16["bound_ms"],
        "earlier_ms_bf16": flash16["cuda_core_ms"],
        "launches_bf16_prefill":
            results["prefill_bf16"]["launches"]["flash_attention"],
        "cases": results["flash"],
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:20",
        "launches": results["mamba"]["launches"]["ssm_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in results["ssm"]
                           if c["dtype"] == "float32"),
        "ms": ssm["ms"],
        "plain_ms": ssm["plain_ms"],
        "bound_ms": ssm["bound_ms"],
        "bound_by": ssm["bound_by"],
        "library_ms": None,
        "exp_bound_ms": ssm["exp_bound_ms"],
        "pipes_bound_ms": ssm["pipes_bound_ms"],
        "loads_only_ms": ssm["loads_only_ms"],
        "ms_bf16": ssm16["ms"],
        "bound_ms_bf16": ssm16["bound_ms"],
        "bound_by_bf16": ssm16["bound_by"],
        "loads_only_ms_bf16": ssm16["loads_only_ms"],
        "cases": results["ssm"],
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:25",
        "launches": results["decode_attention_path"]["launches"],
        "max_abs_err": dec["max_abs_err"],
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "ms_bf16": dec16["ms"],
        "library_ms_bf16": dec16["library_ms"],
        "bound_ms_bf16": dec16["bound_ms"],
        "path": results["decode_attention_path"],
        "cases": results["decode_attention"],
    }]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card", card)
    log("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
                f"device {torch.cuda.get_device_name(0)}")

    modules = _kernel_modules()
    t0 = time.perf_counter()
    built = _build.build_many(k.NAME for k in modules.values())
    log("build", f"{len(built)} libraries in {time.perf_counter() - t0!r} s "
                 "(nvcc processes started together)")
    for name, b in built.items():
        log("build", f"{b.path.name}: {b.seconds!r} s")
        for line in b.log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log("build", "  " + line.strip())
    for k in modules.values():
        k.build()                     # binds the library just built
    fk, dk = modules["flash_attention"], modules["decode_attention"]
    log("build", "dynamic shared memory of flash_tc_kernel (ptxas reports "
                 "static memory only): "
                 + ", ".join(f"D={d} {fk.tc_plan(d).smem_bytes} B"
                             for d in fk.TC_HEAD_DIMS)
                 + "; decode_bf16_kernel CTAs per SM (occupancy "
                 "calculator): "
                 + ", ".join(f"D={d} {dk.bf16_ctas_per_sm(d, 0)}"
                             for d in dk.HEAD_DIMS))

    results: dict = {}
    start = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        fn(*args)
        log("time", f"{name} {time.perf_counter() - t!r} s (run so far "
                    f"{time.perf_counter() - start!r} s)")

    timed("kernel", phase_kernel, results)
    timed("main", phase_main, results)
    timed("profile", phase_profile, results)
    timed("whole path", phase_whole_path)
    timed("model kernels", phase_model_kernels, results)
    model = _smollm()
    timed("prefill", phase_prefill, results, model)
    timed("decode", phase_decode, results, model)
    del model
    timed("serve", phase_serve, results)
    timed("ssm kernel", phase_ssm_kernel, results)
    timed("decode kernel", phase_decode_kernel, results)
    timed("mamba", phase_mamba, results)
    timed("prefill bf16", phase_prefill_bf16, results)

    kernels = kernel_entries(results)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
