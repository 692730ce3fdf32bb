#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

  1. card   — nvidia-smi's name and power limit;
  2. build  — nvcc builds the six kernels of csrc/ (channel_ring.cu,
              rmsnorm.cu, flash_attention.cu, ssm_scan.cu,
              decode_attention.cu, with the header tf32x3.cuh, and
              sketch_buckets.cu; sm_90a),
              all started together; build time, ptxas registers and
              spills, and each decode split kernel's CTAs per SM and
              dynamic shared memory;
  3. kernel — random tick traffic (drops, in-slot collisions, 2*D ticks,
              D=256, B=16; the tick an int32 in device memory, from which
              the kernel takes its slot) and adversarial traffic (D ticks from a ring
              holding cells below -1 and additive -0.0, expanded payloads,
              most sends masked out) through the sporades, mandator,
              paxos (plain: the additive request forwards, K=14; Mandator
              mode: K=11) and additive ring layouts at n=5, and the four
              protocols' layouts at n=9: the fused commit (one launch that
              reads the sends where they lie) and the plain PyTorch path
              (commit_entries, pack_entries, ring_commit_ref) bit for bit
              equal after every tick; then, in one call, for each
              protocol's layout at n=5, the device time
              (CUDA events) of the fused launch, of commit_entries +
              pack_entries alone (the preparation the launch absorbs) and
              of the plain path, beside the bytes-based bound at 3.35 TB/s,
              and the host time per call of the fused and the plain path;
  4. main   — the Fig-6 sweep at full size through the port's entry point:
              run_sweep("mandator-sporades", SMRConfig(), 4 rates x 4
              seeds) = 16 lanes, n=5, 10 000 ticks, D=256, as one captured
              tick graph (core/compile_cache.py): the warm-up tick eager,
              one capture, 9 999 replays; the kernel on the path (its
              wrapper's launches, for the warm-up and the capture, and the
              replays' launches of its graph nodes, read around this run
              only: 2 a tick in all);
  5. profile — ticks 500-600 of that grid as graph replays, untraced
              (wall per tick) and under torch.profiler (kernel launches
              and device busy time per tick, the top kernels), beside the
              graph's own kernel nodes (its DOT dump) and the same window
              run eagerly from the same state;
  6. whole path — 1.5 s runs of baseline and leader-crash-recover with
              the kernel and with the plain version, bitwise equal (2 s
              runs until the model phases were added; 1.5 s still enters
              the async path, as tests/test_torch_slice.py checks); the
              same points for 1 s on the card and on the CPU from one
              arrival table, bitwise equal: the integer traces and every
              float metric (SAME_LEAVES);
 6c. graph  — the captured tick against the eager loop on the card
              (harness._eager_on_card), bit for bit on every carried leaf,
              trace leaf and result: phase 6's 1.5 s baseline and
              leader-crash-recover runs of the four scan protocols, a
              closed-loop grid and telemetry full, with both walls; then
              the audit (analysis/graph_lint.py) on the card: G1-G4 over
              the reference's audit grid, its verdict printed and landed
              with graph_lint.append_history in a BENCH_history.jsonl
              ledger under a temporary directory, read back and compared
              (history.format_compare) against the ledger's first entry;
 6b. protocols — the rest of the paper's comparison through the entry
              points (run_sweep), tracing and monitoring off: (a) the full
              Fig-6 grids of mandator-paxos (50k/150k/300k/450k) and
              multipaxos (10k/30k/50k/100k tx/s) x seeds 0-3, 10 000
              ticks: wall, lane-ticks/s, ms/tick, the ring's D, and the
              channel_ring_commit launches counted around each run alone
              (2 and 1 per tick, as in phase 4); every point commits and
              stays within 1.05 x its rate; ticks 500-600 of each grid
              profiled as in phase 5; (b) mandator alone at Fig 6's
              mandator-sporades rates for 2 s (1 launch per tick,
              profiled); (c) for
              mandator-paxos, multipaxos and mandator on baseline,
              leader-crash-recover and paper-ddos, from one arrival table
              for 1 s: kernel vs plain on the card and card vs CPU, every
              float metric of the row bit for bit (same_leaves); (d)
              epaxos and rabia (host models) at Fig 6's rates and each
              protocol's best throughput with median < 1 s, as
              benchmarks/figures.py reckons it; (e) Fig 7: the leader of
              view 0 crashes for good at mid-run (100k tx/s, 2 s), the
              timelines and `recovered` of mandator-sporades,
              mandator-paxos and multipaxos; (f) Fig 8's plan under
              paper-ddos (2 s; epaxos halved and doubled as there); (g)
              Fig 9: mandator-sporades at n = 3, 7, 9 for 1 s;
 6d. dispatch — the asynchronous dispatch: phase 4's and 6b's grids
              (mandator-sporades seeds 0-3 and again with seeds 4-7, two
              dispatches of one program pending together; mandator-paxos
              and multipaxos; mandator alone 2 s; epaxos and rabia)
              through one experiment.run_sweeps, each dispatch under
              torch.cuda.set_sync_debug_mode("error") (a first capture,
              which synchronizes by design, excepted and counted); every
              row bitwise equal to the row the earlier phase (or, for seeds
              4-7, a run_sweep here) computed sequentially; the
              channel_ring_commit launches of the whole call (2 / 2 / 1 / 1
              a tick); the wall of run_sweeps, the host seconds inside the
              dispatches and inside the collects, and the sum of the same
              grids' sequential walls;
  7. model kernels — RMSNorm (RMS_CASES: [8192, 576] and [4, 576],
              float32 and bfloat16, with and without residual, float32 and
              bfloat16 weights; d_model 8192; D = 100; x views off a
              16-byte boundary; musicgen-medium's [8192, 1536]; each with
              the kernel's launch plan) and flash attention
              (SmolLM-135M's B=4 S=2048 H=9 Kh=3 D=64 causal, a ragged
              S=1000, qwen3-14b's D=128 H=40 Kh=8, a non-causal S=512,
              musicgen-medium's MHA H=Kh=24 D=64, each in float32 (the 3xTF32 tensor-core kernel) and bfloat16
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
              5e-3 of the prefill's at every position, ms per step, and
              the last 4 steps timed and profiled again (launches per step,
              device busy share; 16 until PR 22);
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
              SDPA at that shape, at qwen3-14b's (B=8 H=40 Kh=8 D=128
              S=8192, full and ragged) and at musicgen-medium's MHA (B=4
              H=Kh=24 D=64 S=2048, full and ragged), float32 (the 3xTF32 tensor-core
              kernel) and bfloat16, each also against its twin at the
              kernel's split plan, element by element (float32:
              decode_attention_tf32x3_order; bfloat16:
              decode_attention_kernel_order), the float32 cases against a
              float64 oracle too, with
              the split plan, the time per launch, the float32 kernel's
              copies alone (decode_attention_loads_cuda, uncounted), the
              bound, the plain version's and SDPA's times; and the entry
              point against the model's chunked kv_len route
              (layers.chunked_attention);
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
 15. workloads — windowed and closed-loop workloads, the flight recorder
              and the health monitor through the entry points: (a)
              benchmarks/figures.py's workload matrix at its full 4 s:
              the seven library
              workloads x {baseline, paper-ddos}, one 14-lane grid per
              scan protocol (mandator-sporades, mandator-paxos and
              mandator at 200k tx/s, multipaxos at 30k), with the
              channel_ring_commit launches counted around each grid alone
              and a profile of ticks 200-300 as in phase 5;
              every lane commits and no closed lane's in-flight high water
              passes its cap; EPaxos at 8k and Rabia at 800 on the
              baseline; (b) onoff-burst, region-skew, closed-loop and
              skewed-closed x {baseline, paper-ddos} for 1 s from one numpy
              arrival table and one epoch stream: kernel vs plain and card
              vs CPU bit for bit (same_leaves and inflight_max); (c) the
              robustness matrix (10 scenarios x 2 rates, three protocols;
              cut to 2 s) with trace_level and monitor_level "full" against
              the same grid with both off: metrics bit for bit, every
              verdict clean but for the reference's own Mandator-Paxos
              agreement counts on paper-ddos, region-outage, gray-wan and
              flapping-link, which must equal KNOWN_VIOLATIONS exactly,
              each batch's phase marks ordered and the rows' median and
              p99 recomputed from the marks' commit - arrival,
              a Chrome trace that validates, ms/tick on and off, and
              launches/tick and busy share of ticks 100-200 on and off;
 16. reduced sweeps — the reduced path, run_sweep(..., mesh=1): (a) the
              mandator-sporades Fig-6 grid (16 lanes x 10 000 ticks) with
              every scalar (throughput, median_ms, p99_ms, committed,
              async_frac, views) bit for bit equal to phase 4's rows, no
              key of harness.REDUCED_DROPS and a [64] sketch; wall,
              ms/tick and bytes read back per row, reduced vs
              unreduced; 2 channel_ring_commit launches a tick (as in
              phase 4) and one sketch_buckets launch, whose captured inputs then hold the
              kernel against its plain version on the CPU (bit for bit)
              and on the card (index_add_, within SKETCH_CARD_REL), with
              its time, bound, the plain version's and index_add_'s
              times; (b) the same for multipaxos against phase 6b's
              rows; (c) 1 s of baseline and leader-crash-recover at
              100k tx/s from one arrival table on the card and on the
              CPU: sketch v and w bit for bit, each lane's sketch median
              within 10% of the exact one (the reference test's band;
              the p99 gap printed, unbounded); (d) grid_mesh past the
              card count raises;
 17. train  — the training path: (a) launch.train.train("smollm-135m",
              reduced=False, steps=20, batch=8, seq=512) on the card (30
              layers, d 576, f32, dense attention, AdamW, Sporades
              commits): walls per step, tokens/s, peak memory, the losses
              (the last below the first) and every step committed; no
              hand-written kernel runs (the reference's training runs
              none); (b) 5 steps of make_train_step on the card and on the
              CPU from one parameter set and the same batches, reduced
              smollm-135m and jamba (attention, Mamba, MoE), int8 moments
              on: losses within 1e-5 relative, parameters within 1e-5;
              since PR 23 also reduced xlstm-1.3b (its limits 4x the CPU's
              own divergence from the same steps with the embeddings one
              ulp off, where that is larger) and llama-3.2-vision-11b;
              (c) a backward through each kernel route (pallas attention,
              pallas norm, the ssm_scan kernel) raises;
 18. moe    — dbrx-132b at its published widths (d 6144, 48/8 heads,
              D 128, 16 experts top-4, d_ff 10752, vocab 100352) cut to
              depth 2, random bf16 weights: (a) the [4, 1024] prefill with
              the flash (tensor-core) and RMSNorm kernels (2 and 5
              launches), kernels vs plain logits, and each kernel held
              against its plain version at these shapes with times,
              bounds and the library call's; (b) a 32-token
              greedy_generate at B = 4 (ms a decode step, peak memory);
              (c) one MoE layer at full width in float32 against the same
              function in float64 on the card: routing (top-k, dispatch)
              equal, y within 1e-4 relative;
 19. xlstm + vision — the last two families at their published widths,
              random weights: (a) xlstm-1.3b (48 layers, 42 mLSTM + 6
              sLSTM, d 2048, 4 heads, dh 1024, chunk 128, 2 321 033 552
              params): at full depth the [4, 2048] prefill in f32 and in
              bf16 with the RMSNorm kernel (49 launches each), walls,
              tokens/s, peak memory, the wall split between the mLSTM and
              the sLSTM layers (and one layer of each profiled), 32 decode
              steps (ms a step); the logits beside the plain path's
              one-ulp spread, unbounded (float32 rounding alone moves them
              by O(1) at this depth); at depth 8 (one super-block) kernels
              vs plain within 1e-3, 256 decode steps vs the prefill within
              5e-3 (each or 4x the one-ulp spread, where larger) and the
              bf16 rule; each mixer's recurrent form vs its forward at full
              width within 5e-3; RMSNorm vs plain at [8192, 2048];
              (b) llama-3.2-vision-11b (40 layers, 8 with cross-attention
              over a 1601-token stub memory, d 4096, 32/8 heads, D 128,
              10 110 734 336 params, bf16): the [2, 2048] prefill with
              the flash and RMSNorm kernels (40 and 89 launches), a
              32-token greedy_generate from a 16-token prompt, flash and
              RMSNorm vs plain at these shapes (times, bounds, SDPA's and
              F.rms_norm's), and at depth 5 (one super-block with its
              cross layer) the bf16 logits vs a float32 forward (the
              kernels' error at most 1.5x the plain path's);
 20. mesh   — the mesh and sharding layer (distributed/sharding.py,
              DTensor placements, local_map around the kernels) on a 1x1
              ("data", "model") mesh, NCCL with one rank: (a) smollm-135m
              at full width, 5 make_train_step steps of [8, 512] f32 dense
              with parameters, moments and batches placed by
              param_shardings, _opt_shardings and batch_shardings against
              the same steps unsharded: losses and parameters within 1e-6
              relative, whether they are bitwise and the first leaf that
              is not, both step walls; (b) the bf16 [4, 2048] prefill with
              the flash and RMSNorm kernels through the mesh (30 and 61
              launches through local_map), logits bit for bit the
              unsharded kernels', its wall beside phase 14's; (c) the dry
              run (launch/dryrun.run_cell) of cell (a) on a fake 1x1
              mesh: its per-device argument bytes equal the CUDA
              allocator's requested bytes from placing params, moments
              and batch, its FLOPs FlopCounterMode's count of a real step
              on the card, exactly; its compute and memory terms beside
              the measured step wall; (d) the dry run of four production
              cells on the 16x16 mesh (256 fake ranks): smollm-135m
              train_4k, qwen3-14b decode_32k, dbrx-132b train_4k,
              jamba-1.5-large-398b prefill_32k: seconds, per-device
              bytes, the roofline terms, the dominant one, whether the
              cell fits one H100 80 GB;
 21. examples — the slice's two halves: (a) each examples/torch_*.py's
              main() on the card at the reference script's own sizes: the
              wan demo's paper tour (Fig 6's ordering, mandator-sporades
              >= 2x multipaxos >= 2x epaxos >= 2x rabia; a dip after the
              leader crash at 1.5 s, some bucket below half the one
              before), --scenario region-outage, --workload closed-loop
              --scenario paper-ddos and --trace ... --scenario paper-ddos
              --rate 300000 (obs.export.validate on the trace written);
              quickstart (a falling loss, every step committed, tokens in
              range), train_smr_cluster (commits 30, 30, 10, every
              Sporades record committed) and serve_batch (tokens in
              range); walls and launches; (b) musicgen-medium at full
              width and depth (48 layers, d 1536, MHA 24 heads of 64,
              frame embeddings, 1 815 234 048 params, seed 0): the
              frame_emb [4, 2048] prefill in f32 (kernels vs plain within
              1e-3, 48 flash launches on the 3xTF32 kernel and 97 RMSNorm)
              and in bf16 (48 on the tensor-core kernel; the 1.5x rule
              against a float32 forward), decode vs the prefill over 64
              positions at B = 4 within 5e-3 (ms a step, launches, busy
              share), serve(reduced=False, batch 4, prompt 16, gen 32),
              peak memory; (c) its kernel cases (flash and decode at
              H = Kh = 24, D 64, S 2048; RMSNorm at [8192, 1536]) run in
              phases 7 and 12 beside every other case;
 22. the tick programs of the whole script (captures, their seconds,
              replays, the kernels they launched), the card's line, the
              kernels line, then the result line.

It imports nothing of JAX and nothing of the JAX package. Float32 matrix
products and convolutions run in full float32 (TF32 off).
"""
from __future__ import annotations

import json
import math
import os
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
COMMIT_KERNEL = "commit_kernel"    # in csrc/channel_ring.cu's kernel's name
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


def layouts(n: int = 5):
    """Each ring layout phase 3 drives: {name: (RingSpec, the tick's send
    names in its order)}, at ``n`` replicas."""
    from repro_torch.core import channel as ch
    from repro_torch.core import mandator, paxos, sporades
    return {
        # the sporades tick's eight sends, in its order
        "sporades": (sporades.ring_spec(n),
                     ("vote", "prop", "to", "pa", "va", "pa", "ac", "vote")),
        "mandator": (mandator.ring_spec(), ("vote", "batch")),
        # Multi-Paxos: the additive request forwards carry real traffic
        "paxos": (paxos.ring_spec(n, False), ("fw", "acc", "ack")),
        "mandator-paxos": (paxos.ring_spec(n, True), ("acc", "ack")),
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
    once (a masked-out send still merges its neutral value); and the tick
    itself, one int32 read."""
    import torch
    Bn, Dn, n, _, K = buf.shape
    seen, inputs = set(), K * 4 + 4
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

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0.0
    # n = 9 (Fig 9's largest cluster) changes n and K for every layout
    cases = [(5, name) for name in layouts()] + [
        (9, name) for name in layouts(9) if name != "additive"]
    for n, name in cases:
        spec, names = layouts(n)[name]
        for traffic in ("random", "adversarial"):
            if traffic == "random":
                ring_k = ch.make_ring(spec, D, n, B, torch.device("cuda"))
            else:
                ring_k = adversarial_ring(spec, n, gen, ch)
            ring_r = {"buf": ring_k["buf"].clone()}
            ticks = 2 * D if traffic == "random" else D
            # the tick as the loop carries it: one int32 in device memory,
            # from which the kernel and the plain path take the slot
            tt = torch.zeros((), dtype=torch.int32, device="cuda")
            for t in range(ticks):
                # adversarial: expanded payloads, most sends masked out
                sends, drop = random_sends(
                    spec, names, n, gen, ch, expand=traffic != "random"
                    and t % 2 == 0, p_mask=0.5 if traffic == "random"
                    else 0.2)
                ring_k = ch.ring_commit(spec, ring_k, tt, sends, drop=drop,
                                        backend="cuda")
                ring_r = ch.ring_commit(spec, ring_r, tt, sends, drop=drop,
                                        backend="ref")
                tt.add_(1)
                if not torch.equal(ring_k["buf"].view(torch.int32),
                                   ring_r["buf"].view(torch.int32)):
                    diff = (ring_k["buf"] - ring_r["buf"]).abs().max().item()
                    raise AssertionError(f"{name} n={n} {traffic}: kernel "
                                         f"!= plain at tick {t} (max abs "
                                         f"diff {diff})")
            log("kernel", f"{name} ({traffic}): n={n} K={spec.k} "
                          f"E={len(names)} B={B} D={D}, {ticks} ticks with "
                          "t in device memory, kernel == plain bitwise "
                          "(int32 bits) after every tick")

    n = 5
    per_layout = {}
    for name in ("sporades", "mandator", "paxos", "mandator-paxos"):
        spec, names = layouts()[name]
        ring = ch.make_ring(spec, D, n, B, torch.device("cuda"))
        sends, drop = random_sends(spec, names, n, gen, ch, expand=True)
        t = torch.full((), 3, dtype=torch.int32, device="cuda")
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
    counts = _counts()
    launches = counts["channel_ring_commit"]
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
                f"{wall / ticks * 1e3!r} ms/tick; {_graph_line(counts)}")
    commits = _check_launches("mandator-sporades", counts, ticks, "main")
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
    results["graph_launches"] = counts["channel_ring_commit_graph"]
    results["commits"] = commits
    results["main_programs"] = counts["_programs"]
    results["wall_s"] = wall
    results["fig6_rows"] = {"mandator-sporades": rows}


def _clone(tree):
    """Deep copy of a (nested) dict of tensors: the tick updates the rings
    in place."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _profile_window(fn, n_window: int):
    """(kernel launches per tick, device ms per tick) of ``fn()`` under
    torch.profiler; (None, 0.0) where it saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return (sum(e.count for e in kernels) / n_window,
            dev_us / 1e3 / n_window, top)


# ticks a tick profile replays (traced and untraced) and runs eagerly;
# 200 and 50 until PR 22, halved in PR 23 to make room for phase 19
PROFILE_TICKS, PROFILE_EAGER_TICKS = 100, 25


def tick_profile(tag: str, protocol: str, rates, start: int,
                 n_window: int = PROFILE_TICKS, cfg=None, spec=None):
    """Where a tick's time goes: the grid of ``protocol`` (by default the
    16-lane Fig-6 grid at ``rates`` x FIG6_SEEDS under SMRConfig(); else
    ``spec`` under ``cfg``, any workload and telemetry level) runs to tick
    ``start`` through its tick graph (the warm-up tick, then replays), and
    ticks start .. start + n_window then run as replays, once untraced
    (wall, the device drained at both ends) and once under torch.profiler
    (the graph's kernels as the profiler sees them), beside the graph's
    own kernel nodes (its DOT dump); then the window's first
    PROFILE_EAGER_TICKS ticks from the same state run eagerly
    (``harness.step``), untraced, and the next as many profiled. The
    busy share is the traced device time over the untraced wall of the
    same window. Returns the per-tick numbers of both."""
    import torch

    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import compile_cache, experiment, harness, netsim
    from repro_torch.core.experiment import SweepSpec

    dev = torch.device("cuda")
    spec = spec or SweepSpec(rates=rates, seeds=FIG6_SEEDS)
    _, cfg, mode, env, rate_b, seeds = experiment._lower(
        cfg or SMRConfig(), spec, dev, canonical=True)
    ticks = netsim.sim_ticks(cfg)
    arr = harness.make_arrivals(
        cfg, mode, rate_b.tolist(), seeds, dev,
        experiment._lower_workloads(cfg, spec, canonical=True))
    run = harness._setup(protocol, cfg, ticks, env, arr, len(seeds), dev)
    harness._warm(run, protocol, cfg)
    key = harness._program_key(protocol, cfg, run["arr"], False,
                               run["carry"], run["inputs"])
    carry, prog = compile_cache.run(
        key, protocol, harness._graph_tick(run, protocol, cfg),
        run["carry"], run["inputs"], run["t"], start - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.replay(n_window)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_window
    g_launches, g_dev, g_top = _profile_window(
        lambda: prog.replay(n_window), n_window)
    nodes = prog.nodes
    kernel_nodes = sum(nodes["kernels"].values())
    commit_nodes = sum(k for name, k in nodes["kernels"].items()
                       if COMMIT_KERNEL in name)

    def eager(state, t, n):
        for _ in range(n):
            state = harness.step(state, t, run["arr"], env, cfg, protocol,
                                 run["grace"])
            t.add_(1)
        return state
    t = run["t"].clone()                              # tick `start`
    state = _clone(carry)
    e_n = min(n_window, PROFILE_EAGER_TICKS)  # eager ticks cost 10-20 ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eager(state, t, e_n)
    torch.cuda.synchronize()
    e_wall = (time.perf_counter() - t0) * 1e3 / e_n
    e_launches, e_dev, _ = _profile_window(lambda: eager(state, t, e_n),
                                           e_n)
    log(tag, f"{protocol} ticks {start}-{start + n_window} as graph "
             f"replays: {wall_ms!r} ms/tick wall; the graph: "
             f"{nodes['nodes']} nodes, {kernel_nodes} kernel nodes "
             f"({commit_nodes} channel_ring_commit), "
             f"{nodes['types']}; captured in {prog.capture_s!r} s")
    if g_dev > 0:
        log(tag, f"  replays traced: {g_launches!r} kernel launches/tick, "
                 f"device busy {g_dev!r} ms/tick of {wall_ms!r} ms/tick "
                 f"wall (busy share {g_dev / wall_ms!r})")
        for e in g_top:
            log(tag, f"    {e.self_device_time_total / n_window!r} "
                     f"us/tick x{e.count / n_window:g}/tick  {e.key[:90]}")
    else:
        log(tag, "  torch.profiler recorded no device time in the "
                 "replays: the graph's busy share not measured")
    log(tag, f"  eager, the window's first {e_n} ticks from the same "
             f"state: {e_wall!r} ms/tick wall; the next {e_n} profiled: "
             f"{e_launches!r} launches/tick, device busy {e_dev!r} "
             f"ms/tick (busy share "
             f"{e_dev / e_wall if e_dev > 0 else float('nan')!r}); graph "
             f"{e_wall / wall_ms!r}x faster")
    return {"wall_ms_per_tick": wall_ms,
            "kernel_nodes_per_tick": kernel_nodes,
            "graph_nodes_per_tick": nodes["nodes"],
            "commit_nodes_per_tick": commit_nodes,
            "launches_per_tick": g_launches if g_dev > 0 else None,
            "device_ms_per_tick": g_dev if g_dev > 0 else None,
            "busy_share": g_dev / wall_ms if g_dev > 0 else None,
            "capture_s": prog.capture_s,
            "eager_wall_ms_per_tick": e_wall,
            "eager_launches_per_tick": e_launches,
            "eager_device_ms_per_tick": e_dev,
            "eager_busy_share": e_dev / e_wall if e_dev > 0 else None}


def phase_profile(results: dict) -> None:
    """Phase 5: ticks 500-600 of the mandator-sporades Fig-6 grid, as
    graph replays and eagerly."""
    prof = tick_profile("profile", "mandator-sporades", FIG6_RATES, 500)
    log("profile", f"the whole sweep: {results['wall_s'] / 10_000 * 1e3!r} "
                   "ms/tick")
    results["profile"] = prof


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


# every leaf of a result row that phases 6 and 6b hold bit for bit: the
# float metrics, since their sums are exact (core/harness.py
# _batch_metrics), and for mandator-sporades its integer traces too (the
# other protocols' rows carry none, as the reference's)
METRIC_LEAVES = ("throughput", "median_ms", "p99_ms", "committed",
                 "timeline", "origin_median_ms", "origin_p99_ms",
                 "origin_timeline", "origin_lat_ms_timeline")
SAME_LEAVES = ("cvc_all", "commit_key", "views", "async_frac") + METRIC_LEAVES


def same_leaves(protocol: str) -> tuple:
    return SAME_LEAVES if protocol == "mandator-sporades" else METRIC_LEAVES


def _assert_same(a, b, names, what, leaves=SAME_LEAVES,
                 same_keys=True) -> None:
    """Every leaf of ``leaves`` equal bit for bit (floats compared as
    their float32 bits, so NaN equals NaN and -0.0 differs from 0.0);
    with ``same_keys``, the rows' keys equal too."""
    import numpy as np
    for x, y, name in zip(a, b, names):
        if same_keys and set(x) != set(y):
            raise AssertionError(f"{what}: {name} rows' keys differ")
        for k in leaves:
            u, v = np.asarray(x[k]), np.asarray(y[k])
            if u.dtype.kind == "f":
                u, v = (t.astype(np.float32).view(np.uint32) for t in (u, v))
            if u.shape != v.shape or not np.array_equal(u, v):
                raise AssertionError(f"{what}: {name} {k} differs: "
                                     f"{x[k]!r} != {y[k]!r}")


# ---------------------------------------------------------------------------
# phase 6c: the captured tick against the eager loop; the audit (G1-G4)
# ---------------------------------------------------------------------------

SCAN_PROTOCOLS = ("mandator-sporades", "mandator-paxos", "multipaxos",
                  "mandator")


def _same_tree(a, b, what: str, path: str = "") -> int:
    """Every leaf of two nested dicts of tensors (or arrays, scalars)
    equal bit for bit, floats as their bits, so that NaN equals NaN and
    -0.0 differs from 0.0; a flight recorder's ring (``tr.buf``) without
    its spill slot, the last, where the events a tick does not keep are
    scattered several to one place (``obs/trace.py``). Returns the leaves
    compared."""
    import numpy as np
    import torch
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: keys of {path or 'the root'} "
                                 f"differ: {sorted(set(a) ^ set(b))}")
        return sum(_same_tree(a[k], b[k], what, f"{path}{k}.") for k in a)
    if a is None or b is None:
        if not (a is None and b is None):
            raise AssertionError(f"{what}: {path} is None on one side")
        return 1
    x = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    y = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    if path.endswith("tr.buf."):
        x, y = x[:, :, :-1], y[:, :, :-1]
    if x.dtype != y.dtype or x.shape != y.shape:
        raise AssertionError(f"{what}: {path} {x.dtype}{x.shape} vs "
                             f"{y.dtype}{y.shape}")
    if x.dtype.kind == "f":
        x, y = (v.view(np.uint32 if v.itemsize == 4 else np.uint64)
                for v in (np.ascontiguousarray(x), np.ascontiguousarray(y)))
    if not np.array_equal(x, y):
        raise AssertionError(f"{what}: {path} differs")
    return 1


def phase_graph(results: dict) -> None:
    """Phase 6c: graph against eager on the card, bit for bit: every
    carried leaf, every trace leaf and every result (``sim_point``'s dict)
    of phase 6's 1.5 s baseline and leader-crash-recover runs for the four
    scan protocols, a closed-loop grid (closed-loop and onoff-burst,
    mandator-sporades) and telemetry full (mandator-paxos); the walls of
    both. Then (the audit) ``graph_lint.audit`` on the card, G1-G4 over
    the reference's audit grid."""
    import dataclasses

    import torch
    from repro_torch.analysis import graph_lint
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import compile_cache, experiment, harness, netsim
    from repro_torch.core.experiment import SweepSpec
    from repro_torch.scenarios import library
    from repro_torch.workloads import library as wlib

    dev = torch.device("cuda")
    sim_s = 1.5
    names = ("baseline", "leader-crash-recover")
    cfg = SMRConfig(sim_seconds=sim_s)
    scen = tuple(library.get(x, sim_s) for x in names)
    fig6 = SweepSpec(rates=(100_000,), scenarios=scen)
    cases = [(p, "baseline+leader-crash-recover", cfg, fig6)
             for p in SCAN_PROTOCOLS]
    cases.append(("mandator-sporades", "closed-loop+onoff-burst", cfg,
                  SweepSpec(rates=(100_000,), scenarios=scen,
                            workloads=(wlib.get("closed-loop", sim_s),
                                       wlib.get("onoff-burst", sim_s)))))
    cases.append(("mandator-paxos", "telemetry full",
                  dataclasses.replace(cfg, trace_level="full",
                                      monitor_level="full"), fig6))
    out = results.setdefault("graph", {})
    for proto, tag, c, spec in cases:
        _, rcfg, mode, env, rate_b, seeds = experiment._lower(
            c, spec, dev, canonical=True)
        arr = harness.make_arrivals(
            rcfg, mode, rate_b.tolist(), seeds, dev,
            experiment._lower_workloads(rcfg, spec, canonical=True))
        ticks = netsim.sim_ticks(rcfg)
        runs = {}
        for path in ("graph", "eager"):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == "eager":
                with harness._eager_on_card():
                    st, tr = harness._scan_body(proto, rcfg, ticks, env,
                                                arr, len(seeds), dev)
            else:
                st, tr = harness._scan_body(proto, rcfg, ticks, env, arr,
                                            len(seeds), dev)
            res = harness._results(proto, rcfg, st, tr, arr).checked()
            torch.cuda.synchronize()
            runs[path] = (st, tr, res, time.perf_counter() - t0,
                          compile_cache.stats())
        g, e = runs["graph"], runs["eager"]
        n = sum(_same_tree(g[i], e[i], f"{proto} {tag} graph vs eager")
                for i in range(3))
        if e[4]["captures"] or g[4]["replays"] != ticks - 1:
            raise AssertionError(f"{proto} {tag}: graph {g[4]}, eager "
                                 f"{e[4]}")
        log("graph", f"{proto} {tag} ({len(seeds)} lanes x {ticks} "
                     f"ticks): graph == eager bit for bit on {n} leaves "
                     f"(carry, trace, results); wall graph {g[3]!r} s "
                     f"({g[4]['captures']} capture, "
                     f"{g[4]['capture_s']!r} s) vs eager {e[3]!r} s "
                     f"({e[3] / g[3]!r}x)")
        out[f"{proto} {tag}"] = {"leaves": n, "graph_s": g[3],
                                 "eager_s": e[3],
                                 "capture_s": g[4]["capture_s"]}

    t0 = time.perf_counter()
    v = graph_lint.audit(device="cuda", sim_seconds=2.0)
    for line in graph_lint.format_verdict(v).splitlines():
        log("audit", line)
    if not v["ok"]:
        raise AssertionError(f"graph audit: {v['violations']}")
    log("audit", f"G1-G4 clean on the card in {time.perf_counter() - t0!r}"
                 " s")
    results["audit"] = {k: v[k] for k in ("ok", "violations", "protocols",
                                           "wall_s")}
    audit_history(v)


def audit_history(verdict: dict) -> None:
    """Land the audit's verdict in a BENCH_history.jsonl ledger under a
    temporary directory (graph_lint.append_history), read it back and
    print history.format_compare of the latest entry against the ledger's
    first."""
    import tempfile

    from repro_torch.analysis import graph_lint
    from repro_torch.obs import history
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "BENCH_history.jsonl"
        graph_lint.append_history(path, verdict,
                                  analysis_counts={"active": 0})
        entries = history.load(path)
        if len(entries) != 1 or list(entries[0]["suites"]) != [
                "graph-audit"]:
            raise AssertionError(f"history ledger read back {entries}")
        suite = entries[0]["suites"]["graph-audit"]
        if suite["monitor"]["ok"] is not verdict["ok"] or \
                suite["wall_s"] != verdict["wall_s"]:
            raise AssertionError(f"ledger entry {suite} is not the verdict")
        cmp = history.compare(entries[0], history.latest(path))
        for line in history.format_compare(cmp):
            log("audit", f"history: {line}")
        if cmp["graph-audit"]["status"] != "ok":
            raise AssertionError(f"history gate: {cmp}")


# ---------------------------------------------------------------------------
# phase 6b: the other protocols of the paper's comparison (Figs 6-9)
# ---------------------------------------------------------------------------

# benchmarks/figures.py's plans: Fig 6's rate grids, Fig 8's attack points
PAXOS_FIG6 = {"mandator-paxos": (50_000, 150_000, 300_000, 450_000),
              "multipaxos": (10_000, 30_000, 50_000, 100_000)}
ANALYTIC_FIG6 = {"epaxos": (2_000, 5_000, 10_000, 20_000),
                 "rabia": (200, 500, 1_000, 2_000)}
FIG8_PLAN = (("mandator-sporades", 300_000), ("mandator-paxos", 300_000),
             ("multipaxos", 50_000), ("epaxos", 10_000))
# channel_ring_commit launches per tick: one per ring of the protocol
RINGS = {"mandator-sporades": 2, "mandator-paxos": 2, "multipaxos": 1,
         "mandator": 1}
FIG7_8_S = 2.0          # Figs 7 and 8 (figures.py: 4 s)


def _counted(protocol, cfg, spec, **kw):
    """run_sweep with the launch counts set to 0 just before and read just
    after: (rows, wall s, counts: see ``_counts``)."""
    import torch
    from repro_torch.core.experiment import run_sweep
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rows = run_sweep(protocol, cfg, spec, **kw)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0, _counts()


def _check_points(protocol, rows, what) -> None:
    for r in rows:
        if not r["committed"] > 0:
            raise AssertionError(f"{what}: {protocol} {r['rate']}/"
                                 f"{r['seed']} committed nothing")
        if r["throughput"] > 1.05 * r["rate"]:
            raise AssertionError(f"{what}: {protocol} {r['rate']}/"
                                 f"{r['seed']} exceeds its offered rate: "
                                 f"{r['throughput']}")


def _check_launches(protocol, counts, ticks, what) -> int:
    """One run of ``ticks`` ticks went through its tick graph: an eager
    warm-up tick, at most one capture, ``ticks - 1`` replays; the commit
    wrapper launched for the warm-up and the capture alone, and the
    replays launched the commit kernel once a ring a tick. Returns the
    commits run (wrapper's eager ones and the replays')."""
    rings, prog = RINGS[protocol], counts["_programs"]
    wrapper = counts["channel_ring_commit"]
    graph = counts["channel_ring_commit_graph"]
    ok = (prog["graph_runs"] == 1 and prog["eager_ticks"] == 1
          and prog["replays"] == ticks - 1 and prog["captures"] <= 1
          and wrapper == rings * (1 + prog["captures"])
          and graph == rings * (ticks - 1))
    if not ok:
        raise AssertionError(
            f"{what}: {protocol} expected one graph run of {ticks} ticks "
            f"({rings} commit a tick: {rings} or {2 * rings} through the "
            f"wrapper, {rings * (ticks - 1)} by the replays), got wrapper "
            f"{wrapper}, replays' {graph}, programs {prog}")
    return wrapper - rings * prog["captures"] + graph


def _graph_line(counts) -> str:
    p = counts["_programs"]
    return (f"channel_ring_commit launches: {counts['channel_ring_commit']} "
            f"through the wrapper (warm-up tick and capture), "
            f"{counts['channel_ring_commit_graph']} by {p['replays']} "
            f"replays; {p['captures']} capture(s) in {p['capture_s']!r} s")


def phase_protocols(results: dict) -> None:
    """Mandator-Paxos, Multi-Paxos, Mandator alone and the analytic EPaxos
    and Rabia baselines through the port's entry points: (a) the full Fig-6
    grids of the two Paxos protocols, (b) Mandator alone at Fig 6's
    mandator-sporades rates, (c) kernel vs plain and card vs CPU bit for
    bit, (d) the analytic models and the six-protocol Fig-6 summary, (e)
    Fig 7's leader crash, (f) Fig 8's plan, (g) Fig 9 at n = 3, 7, 9."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import experiment
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.scenarios import Crash, Scenario, library

    out = results.setdefault("protocols", {})
    fig6 = results["fig6_rows"]

    # (a) the full Fig-6 grids, 16 lanes x 10 000 ticks each
    cfg = SMRConfig()
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    for proto, rates in PAXOS_FIG6.items():
        rows, wall, launches = _counted(
            proto, cfg, SweepSpec(rates=rates, seeds=FIG6_SEEDS))
        horizon = experiment.timing_stats()[proto]["horizon"]
        for r in rows:
            log("protocols", f"{proto} rate={r['rate']:.0f} "
                             f"seed={r['seed']} "
                             f"throughput={r['throughput']!r} "
                             f"median_ms={r['median_ms']!r} "
                             f"p99_ms={r['p99_ms']!r} "
                             f"committed={r['committed']!r}")
        log("protocols", f"{proto} Fig-6 grid: {len(rows)} lanes x {ticks} "
                         f"ticks, n={cfg.n_replicas}, D={horizon}: wall "
                         f"{wall!r} s, {len(rows) * ticks / wall!r} "
                         f"lane-ticks/s, {wall / ticks * 1e3!r} ms/tick; "
                         f"{_graph_line(launches)}")
        commits = _check_launches(proto, launches, ticks, "Fig-6 grid")
        _check_points(proto, rows, "Fig-6 grid")
        if horizon != D:
            raise AssertionError(f"{proto}: expected a {D}-slot ring, got "
                                 f"{horizon}")
        fig6[proto] = rows
        out[proto] = {"wall_s": wall, "lane_ticks_per_s":
                      len(rows) * ticks / wall, "ms_per_tick":
                      wall / ticks * 1e3,
                      "launches": launches["channel_ring_commit"],
                      "graph_launches":
                          launches["channel_ring_commit_graph"],
                      "launches_per_tick": commits / ticks,
                      "capture_s": launches["_programs"]["capture_s"],
                      "horizon": horizon,
                      "profile": tick_profile("protocols", proto, rates,
                                              500)}

    # (b) Mandator alone at Fig 6's mandator-sporades rates, 2 s
    cfg = SMRConfig(sim_seconds=2.0)
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    rows, wall, launches = _counted(
        "mandator", cfg, SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS))
    log("protocols", f"mandator alone, {len(rows)} lanes x {ticks} ticks: "
                     f"wall {wall!r} s, {wall / ticks * 1e3!r} ms/tick; "
                     f"{_graph_line(launches)}; throughput by rate (seed "
                     "0): " + ", ".join(f"{r['rate']:.0f}: "
                                        f"{r['throughput']!r}"
                                        for r in rows if r["seed"] == 0))
    commits = _check_launches("mandator", launches, ticks, "mandator alone")
    _check_points("mandator", rows, "mandator alone")
    fig6["mandator"] = rows
    out["mandator"] = {"wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
                       "launches": launches["channel_ring_commit"],
                       "graph_launches":
                           launches["channel_ring_commit_graph"],
                       "launches_per_tick": commits / ticks,
                       "profile": tick_profile(
                           "protocols", "mandator", FIG6_RATES, 500,
                           cfg=cfg)}

    # (c) bit for bit, on three scenarios and one arrival table for 1 s:
    # the kernel against the plain path on the card, and the card against
    # the CPU (held to the JAX reference by the repo's tests)
    names = ("baseline", "leader-crash-recover", "paper-ddos")
    cfg = SMRConfig(sim_seconds=1.0)
    spec = SweepSpec(rates=(100_000,), seeds=(0,), scenarios=tuple(
        library.get(x, cfg.sim_seconds) for x in names))
    rng = np.random.RandomState(0)
    draws = rng.poisson(20.0, (len(names), 1000, 5)).astype(np.float32)
    for proto in ("mandator-paxos", "multipaxos", "mandator"):
        leaves = same_leaves(proto)
        runs = {b: run_sweep(proto, dataclasses.replace(
            cfg, channel_backend=b), spec, draws=draws)
            for b in ("cuda", "ref")}
        cpu = run_sweep(proto, cfg, spec, device="cpu", draws=draws)
        _assert_same(runs["cuda"], runs["ref"], names,
                     f"{proto} kernel vs plain", leaves)
        _assert_same(runs["cuda"], cpu, names, f"{proto} cuda vs cpu",
                     leaves)
        log("protocols", f"{proto}: kernel vs plain and card vs CPU (1 s, "
                         f"one arrival table) bitwise equal on "
                         f"{', '.join(names)}: {', '.join(leaves)}; "
                         "throughput " + ", ".join(
                             f"{x} {r['throughput']!r}"
                             for x, r in zip(names, runs["cuda"])))

    # (d) the analytic baselines, then each protocol's best throughput
    # with median < 1 s (benchmarks/figures.py's saturation rule)
    for proto, rates in ANALYTIC_FIG6.items():
        t0 = time.perf_counter()
        fig6[proto] = run_sweep(proto, SMRConfig(), SweepSpec(rates=rates))
        out[proto] = {"wall_s": time.perf_counter() - t0}
    summary = {}
    for proto, rows in fig6.items():
        ok = [r for r in rows if r["median_ms"] < 1_000]
        best = max(ok, key=lambda r: r["throughput"]) if ok else None
        summary[proto] = best["throughput"] if best else 0.0
        log("protocols", f"Fig-6 summary {proto}: best throughput with "
                         f"median < 1000 ms: {summary[proto]!r} tx/s"
                         + (f" (rate {best['rate']:.0f}, seed "
                            f"{best['seed']}, median {best['median_ms']!r} "
                            "ms)" if best else "")
                         + (" [2 s runs]" if proto == "mandator" else ""))
    out["fig6_best"] = summary

    # (e) Fig 7 (leader of view 0 crashes for good at mid-run, 100k tx/s)
    # and (f) Fig 8 (paper-ddos): one batched run per protocol whose
    # lanes cover both figures' points
    cfg = SMRConfig(sim_seconds=FIG7_8_S)
    crash = Scenario("leader-crash", (Crash(start_s=FIG7_8_S / 2,
                                            targets=(0,)),))
    attack = library.get("paper-ddos", FIG7_8_S)
    rate8 = dict(FIG8_PLAN)
    fig7, fig8 = {}, {}
    for proto in ("mandator-sporades", "mandator-paxos", "multipaxos"):
        rows = run_sweep(proto, cfg, SweepSpec(
            rates=(100_000, rate8[proto]), scenarios=(crash, attack)))
        # rate-major points: (100k, crash) first, (rate8, attack) last
        r7, r8 = rows[0], rows[3]
        tl = [round(float(x)) for x in r7["timeline"]]
        recovered = int(np.asarray(r7["timeline"])[-2:].max() > 0)
        fig7[proto] = {"timeline": tl, "recovered": recovered,
                       "throughput": r7["throughput"]}
        log("protocols", f"Fig 7 {proto} (crash at {FIG7_8_S / 2} s): "
                         f"throughput {r7['throughput']!r}, timeline "
                         f"{'|'.join(map(str, tl))}, recovered={recovered}")
        if not recovered:
            raise AssertionError(f"Fig 7: {proto} never recovered")
        fig8[proto] = {"tput": r8["throughput"], "med_ms": r8["median_ms"]}
    r = run_sweep("epaxos", cfg, SweepSpec(rates=(rate8["epaxos"],)))[0]
    # analytic baseline: DDoS modeled as doubled effective RTTs
    fig8["epaxos"] = {"tput": r["throughput"] * 0.5,
                      "med_ms": r["median_ms"] * 2.0}
    for proto, rate in FIG8_PLAN:
        log("protocols", f"Fig 8 {proto} @{rate} under paper-ddos: "
                         f"throughput {fig8[proto]['tput']!r}, median "
                         f"{fig8[proto]['med_ms']!r} ms")
        if not fig8[proto]["tput"] > 0:
            raise AssertionError(f"Fig 8: {proto} committed nothing")
    out["fig7"], out["fig8"] = fig7, fig8

    # (g) Fig 9: mandator-sporades at n = 3, 7, 9 (the card ran only n = 5)
    fig9 = {}
    for n in (3, 7, 9):
        cfg = SMRConfig(n_replicas=n, sim_seconds=1.0)
        ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
        rows, wall, launches = _counted(
            "mandator-sporades", cfg, SweepSpec(rates=(60_000 * n,)))
        r = rows[0]
        log("protocols", f"Fig 9 n={n} @{60_000 * n}: throughput "
                         f"{r['throughput']!r}, median {r['median_ms']!r} "
                         f"ms, wall {wall!r} s; {_graph_line(launches)}")
        _check_launches("mandator-sporades", launches, ticks, f"Fig 9 n={n}")
        _check_points("mandator-sporades", rows, f"Fig 9 n={n}")
        fig9[n] = {"tput": r["throughput"], "med_ms": r["median_ms"]}
    out["fig9"] = fig9


# ---------------------------------------------------------------------------
# phase 6d: the asynchronous sweep dispatch
# ---------------------------------------------------------------------------

SEEDS_AGAIN = (4, 5, 6, 7)   # the sporades grid's second pending copy


class StrictDispatch:
    """While entered: every ``experiment.dispatch_sweep`` runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a capture, which
    synchronizes by design, runs outside it and is counted), and the host
    seconds inside the dispatches and inside their ``collect()`` add up."""

    def __init__(self):
        self.dispatch_s = self.collect_s = 0.0
        self.dispatches = self.captures = 0

    def __enter__(self):
        import torch
        from repro_torch.core import compile_cache, experiment
        self._real = (experiment.dispatch_sweep, compile_cache.capture)
        real_dispatch, real_capture = self._real

        def capture(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return real_capture(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
                self.captures += 1

        def dispatch(*a, **k):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = real_dispatch(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.dispatch_s += time.perf_counter() - t0
            self.dispatches += 1
            collect = pending.collect

            def timed_collect():
                t1 = time.perf_counter()
                rows = collect()
                self.collect_s += time.perf_counter() - t1
                return rows
            pending.collect = timed_collect
            return pending

        experiment.dispatch_sweep, compile_cache.capture = dispatch, capture
        return self

    def __exit__(self, *exc):
        from repro_torch.core import compile_cache, experiment
        experiment.dispatch_sweep, compile_cache.capture = self._real
        return False


def _bitwise(a, b, what: str) -> None:
    """Equal bit for bit: dicts key for key, arrays by dtype, shape and
    bytes, scalars by type and value (NaN equal to NaN)."""
    import numpy as np
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{what}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            _bitwise(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        if not (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes()):
            raise AssertionError(f"{what} differs")
    elif not (type(a) is type(b) and (a == b or (a != a and b != b))):
        raise AssertionError(f"{what}: {a!r} vs {b!r}")


def _bitwise_rows(got, want, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        _bitwise(g, w, f"{what} row {i}")


def phase_dispatch(results: dict) -> None:
    """Phase 6d (see the module docstring)."""
    import torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import compile_cache, experiment
    from repro_torch.core.experiment import SweepSpec

    fig6, prot = results["fig6_rows"], results["protocols"]
    cfg, cfg2 = SMRConfig(), SMRConfig(sim_seconds=2.0)
    again = SweepSpec(rates=FIG6_RATES, seeds=SEEDS_AGAIN)
    seq_again, seq_wall, _ = _counted("mandator-sporades", cfg, again)
    requests = [("mandator-sporades", cfg,
                 SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS)),
                ("mandator-sporades", cfg, again)]
    requests += [(p, cfg, SweepSpec(rates=r, seeds=FIG6_SEEDS))
                 for p, r in PAXOS_FIG6.items()]
    requests.append(("mandator", cfg2,
                     SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS)))
    requests += [(p, cfg, SweepSpec(rates=r))
                 for p, r in ANALYTIC_FIG6.items()]
    want = [fig6["mandator-sporades"], seq_again]
    want += [fig6[p] for p, _, _ in requests[2:]]
    seq = {"mandator-sporades seeds 0-3": results["wall_s"],
           "mandator-sporades seeds 4-7": seq_wall}
    seq.update({p: prot[p]["wall_s"] for p, _, _ in requests[2:]})

    torch.cuda.synchronize()
    _reset_counts()
    experiment.reset_timing_stats()
    with StrictDispatch() as strict:
        t0 = time.perf_counter()
        got = experiment.run_sweeps(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _counts()
    captured = compile_cache.capture_counts()
    for (proto, _, spec), g, w in zip(requests, got, want):
        _bitwise_rows(g, w, f"run_sweeps {proto} seeds {spec.seeds}")
    scans = [(p, c) for p, c, _ in requests if p in RINGS]
    ticks = [int(c.sim_seconds * 1000 / c.tick_ms) for _, c in scans]
    prog = counts["_programs"]
    # the wrapper launches for each grid's warm-up tick and each capture
    wrapper = sum(RINGS[p] for p, _ in scans) + sum(
        RINGS[p] * n for p, n in captured.items())
    graph = sum(RINGS[p] * (t - 1) for (p, _), t in zip(scans, ticks))
    if (prog["graph_runs"] != len(scans)
            or prog["replays"] != sum(t - 1 for t in ticks)
            or counts["channel_ring_commit_graph"] != graph
            or prog["captures"] != strict.captures
            or counts["channel_ring_commit"] != wrapper):
        raise AssertionError(f"dispatch: {len(scans)} grids, expected "
                             f"{graph} commits by the replays and {wrapper} "
                             f"through the wrapper: {counts}")
    seq_sum = sum(seq.values())
    log("dispatch", f"run_sweeps over {len(requests)} requests "
                    f"({len(scans)} scan grids, two of one sporades "
                    f"program pending together): every row bitwise equal "
                    f"to its sequential run; {strict.dispatches} "
                    f"dispatches under set_sync_debug_mode('error'), "
                    f"{strict.captures} of them captured a program "
                    f"(synchronizing, excepted)")
    log("dispatch", f"channel_ring_commit launches: "
                    f"{counts['channel_ring_commit']} through the wrapper "
                    f"(warm-up ticks and captures), "
                    f"{counts['channel_ring_commit_graph']} by "
                    f"{prog['replays']} replays")
    log("dispatch", f"run_sweeps wall {wall!r} s; host inside the "
                    f"dispatches {strict.dispatch_s!r} s, inside the "
                    f"collects {strict.collect_s!r} s; the same grids run "
                    f"sequentially {seq_sum!r} s ("
                    + ", ".join(f"{k} {v!r}" for k, v in seq.items())
                    + f"); ratio {wall / seq_sum!r}")
    log("dispatch", f"timing_stats: {experiment.timing_stats()}")
    results["dispatch"] = {"wall_s": wall, "dispatch_s": strict.dispatch_s,
                           "collect_s": strict.collect_s,
                           "sequential_s": seq_sum, "sequential": seq,
                           "captures": strict.captures}


# ---------------------------------------------------------------------------
# phase 15: windowed and closed-loop workloads, the flight recorder and the
# health monitor
# ---------------------------------------------------------------------------

# benchmarks/figures.py workload_matrix: its rates and its full 4 s; the
# seven library workloads x {baseline, paper-ddos}, the analytic models on
# the baseline only
WL_RATES = {"mandator-sporades": 200_000, "mandator-paxos": 200_000,
            "mandator": 200_000, "multipaxos": 30_000}
WL_ANALYTIC = {"epaxos": 8_000, "rabia": 800}
WL_S = 4.0
# benchmarks/figures.py robustness: its rates over the ten library
# scenarios, cut from 4 s to the suite's --quick 2 s for the script's time
ROBUST_RATES = {"mandator-sporades": (50_000, 200_000),
                "mandator-paxos": (50_000, 200_000),
                "multipaxos": (10_000, 30_000)}
ROBUST_S = 2.0
# (protocol, scenario) -> the violation counts the reference's own monitor
# reports on the robustness matrix at ROBUST_S, at each of ROBUST_RATES
# (ROADMAP Queue C): a Mandator-Paxos leader of a later view commits a
# vector clock that does not dominate an earlier leader's (its modelled
# phase 1 adopts no accepted value). tests/test_torch_monitor.py holds
# these counts against the reference and the port on the CPU; every other
# point must report none
KNOWN_VIOLATIONS = {("mandator-paxos", "paper-ddos"): {"agreement": 413},
                    ("mandator-paxos", "region-outage"): {"agreement": 50},
                    ("mandator-paxos", "gray-wan"): {"agreement": 188},
                    ("mandator-paxos", "flapping-link"): {"agreement": 1021}}
BITWISE_WL = ("onoff-burst", "region-skew", "closed-loop", "skewed-closed")
BITWISE_SCEN = ("baseline", "paper-ddos")


def one_table(cfg, spec, seed: int = 0):
    """One arrival table and one epoch stream for a grid, drawn by numpy
    on the host, so that the card and the CPU read the same: [B, T, n]
    Poisson counts at each lane's table rates (read by the open lanes) and
    [B, n, M] unit-rate arrival epochs for the closed lanes (+inf
    elsewhere)."""
    import numpy as np
    from repro_torch.core import experiment, workload

    rate = (np.array([r for r, _, _, _ in spec.points()], np.float64)
            * cfg.tick_ms / 1000.0 / cfg.n_replicas).astype(np.float32)
    wlt = experiment._lower_workloads(cfg, spec)
    lanes = np.arange(len(rate))[:, None]
    lam = rate[:, None, None] * wlt["rate_of"][lanes, wlt["win_of_tick"]]
    rng = np.random.RandomState(seed)
    draws = rng.poisson(lam).astype(np.float32)
    counts = [workload.epoch_count(rate[b], wlt, b)
              if wlt["closed"][b] > 0 else 0 for b in range(len(rate))]
    epochs = np.full((len(rate), cfg.n_replicas, max(max(counts), 1)),
                     np.inf)
    for b, c in enumerate(counts):
        if c:
            epochs[b, :, :c] = np.cumsum(
                rng.exponential(size=(cfg.n_replicas, c)), axis=1)
    return draws, epochs


def _phases_explain(r, cfg, ticks: int):
    """Whether the flight recorder's phase marks explain the row's latency:
    the four marks of every batch that has them are ordered (arrival <=
    create <= stable <= commit <= deliver within 1e-6 tick, as the
    reference's test_obs holds them, so the clamped phases the row reports
    are the marks' differences), and the weighted median and p99
    of commit - arrival over the batches the row counts (commit and create
    marked, past the warm-up) equal the row's median_ms and p99_ms bit for
    bit; None where no batch committed."""
    import numpy as np
    import torch
    from repro_torch.core import harness
    marks, arr, cnt = r["batch_marks_t"], r["batch_arr_t"], r["batch_n"]
    create, commit = marks[0], marks[2]
    full = np.isfinite(marks).all(axis=0) & (cnt > 0)
    counted = (np.isfinite(commit) & np.isfinite(create) & (cnt > 0)
               & (commit >= 0.15 * ticks))
    if not counted.any():
        return None
    steps = np.diff(np.concatenate([arr[None], marks])[:, full], axis=0)
    if not (steps >= -1e-6).all():
        return False
    lat = torch.from_numpy(((commit - arr) * np.float32(cfg.tick_ms)
                            ).reshape(1, -1))
    w = torch.from_numpy(np.where(counted, cnt, 0.0).astype(np.float32)
                         .reshape(1, -1))
    got = [harness._weighted_quantile(lat, w, q).numpy()[0]
           for q in (0.5, 0.99)]
    want = [np.float32(r["median_ms"]), np.float32(r["p99_ms"])]
    return all(a.view(np.uint32) == b.view(np.uint32)
               for a, b in zip(got, want))


def phase_workloads(results: dict) -> None:
    """Phase 15: (a) benchmarks/figures.py's workload matrix through the
    port's entry point at 2 s; (b) kernel vs plain and card vs CPU
    bit for bit on windowed and closed-loop grids from one arrival table
    and one epoch stream; (c) the robustness matrix with the flight
    recorder and the health monitor at full, against the same grid with
    both off."""
    import dataclasses

    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.obs import export, monitor
    from repro_torch.scenarios import library as scenario_library
    from repro_torch.workloads import library as workload_library
    from repro_torch.workloads import lower

    out = results.setdefault("workloads", {})
    n = SMRConfig().n_replicas
    t_part = time.perf_counter()

    # (a) the workload matrix: one 14-lane grid per scan protocol
    cfg = SMRConfig(sim_seconds=WL_S)
    ticks = int(WL_S * 1000 / cfg.tick_ms)
    wlib = workload_library.workloads(WL_S, n)
    slib = scenario_library.scenarios(WL_S, n)
    scen = tuple(slib[x] for x in BITWISE_SCEN)
    caps = {name: float(lower(cfg, w)["cap"]) for name, w in wlib.items()}
    closed = {name for name, w in wlib.items()
              if float(lower(cfg, w)["closed"]) > 0}
    matrix = {}
    for proto, rate in WL_RATES.items():
        spec = SweepSpec(rates=(rate,), scenarios=scen,
                         workloads=tuple(wlib.values()))
        rows, wall, launches = _counted(proto, cfg, spec)
        commits = _check_launches(proto, launches, ticks, "workload matrix")
        for r, (_, _, fi, wi) in zip(rows, spec.points()):
            wname, sname = list(wlib)[wi], BITWISE_SCEN[fi]
            hwm = r["inflight_max"]
            log("workloads", f"{proto} @{rate} {wname}/{sname}: throughput "
                             f"{r['throughput']!r} median "
                             f"{r['median_ms']!r} p99 {r['p99_ms']!r} "
                             f"inflight max {float(hwm.max())!r}")
            if not r["committed"] > 0:
                raise AssertionError(f"workload matrix: {proto} {wname}/"
                                     f"{sname} committed nothing")
            if wname in closed and not (hwm <= caps[wname]).all():
                raise AssertionError(f"workload matrix: {proto} {wname}/"
                                     f"{sname} in flight {hwm} past the "
                                     f"cap {caps[wname]}")
        prof = tick_profile("workloads", proto, None, 200, cfg=cfg,
                            spec=spec)
        log("workloads", f"{proto} matrix: {len(rows)} lanes x {ticks} "
                         f"ticks: wall {wall!r} s, {wall / ticks * 1e3!r} "
                         f"ms/tick; {_graph_line(launches)}")
        matrix[proto] = {"wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
                         "launches": launches["channel_ring_commit"],
                         "graph_launches":
                             launches["channel_ring_commit_graph"],
                         "launches_per_tick": commits / ticks,
                         "profile": prof}
    for proto, rate in WL_ANALYTIC.items():
        t0 = time.perf_counter()
        rows = run_sweep(proto, cfg, SweepSpec(
            rates=(rate,), workloads=tuple(wlib.values())))
        log("workloads", f"{proto} @{rate} (host model, baseline, "
                         f"{time.perf_counter() - t0!r} s): " + ", ".join(
                             f"{r['workload']} {r['throughput']!r}"
                             for r in rows))
    out["matrix"] = matrix
    log("time", f"workloads (a) {time.perf_counter() - t_part!r} s")
    t_part = time.perf_counter()

    # (b) bit for bit, 1 s, one arrival table and one epoch stream
    cfg = SMRConfig(sim_seconds=1.0)
    wlib1 = workload_library.workloads(1.0, n)
    slib1 = scenario_library.scenarios(1.0, n)
    for proto, rate in WL_RATES.items():
        spec = SweepSpec(rates=(rate,),
                         scenarios=tuple(slib1[x] for x in BITWISE_SCEN),
                         workloads=tuple(wlib1[x] for x in BITWISE_WL))
        names = [f"{BITWISE_WL[wi]}/{BITWISE_SCEN[fi]}"
                 for _, _, fi, wi in spec.points()]
        draws, epochs = one_table(cfg, spec)
        leaves = same_leaves(proto) + ("inflight_max",)
        runs = {b: run_sweep(proto, dataclasses.replace(
            cfg, channel_backend=b), spec, draws=draws, epochs=epochs)
            for b in ("cuda", "ref")}
        cpu = run_sweep(proto, cfg, spec, device="cpu", draws=draws,
                        epochs=epochs)
        _assert_same(runs["cuda"], runs["ref"], names,
                     f"{proto} kernel vs plain", leaves)
        _assert_same(runs["cuda"], cpu, names, f"{proto} cuda vs cpu",
                     leaves)
        log("workloads", f"{proto}: kernel vs plain and card vs CPU (1 s, "
                         "one arrival table, one epoch stream) bitwise "
                         f"equal on {', '.join(names)}: {', '.join(leaves)}")

    log("time", f"workloads (b) {time.perf_counter() - t_part!r} s")
    t_part = time.perf_counter()

    # (c) the robustness matrix with telemetry on, against it off
    cfg_off = SMRConfig(sim_seconds=ROBUST_S)
    cfg_on = dataclasses.replace(cfg_off, trace_level="full",
                                 monitor_level="full")
    ticks = int(ROBUST_S * 1000 / cfg_off.tick_ms)
    lib = scenario_library.scenarios(ROBUST_S, n)
    robust = {}
    for proto, rates in ROBUST_RATES.items():
        spec = SweepSpec(rates=rates, scenarios=tuple(lib.values()))
        names = [f"{rate:.0f}/{list(lib)[fi]}"
                 for rate, _, fi, _ in spec.points()]
        off, wall_off, l_off = _counted(proto, cfg_off, spec)
        on, wall_on, l_on = _counted(proto, cfg_on, spec)
        _check_launches(proto, l_off, ticks, "robustness, telemetry off")
        _check_launches(proto, l_on, ticks, "robustness, telemetry on")
        # telemetry adds keys (obs, mon, the phase breakdown) and moves
        # no metric
        _assert_same(on, off, names, f"{proto} telemetry on vs off",
                     same_leaves(proto), same_keys=False)
        checked = 0
        for r, (_, _, fi, _), name in zip(on, spec.points(), names):
            v = monitor.verdict(r)
            known = KNOWN_VIOLATIONS.get((proto, list(lib)[fi]), {})
            if v["violations"] != known:
                raise AssertionError(f"robustness: {proto} {name}: "
                                     f"{monitor.format_verdict(v)}, the "
                                     f"reference's {known or 'none'}")
            if known:
                log("robustness", f"{proto} {name}: "
                                  f"{monitor.format_verdict(v)}, equal to "
                                  "the reference's own count (Queue C)")
            tele = _phases_explain(r, cfg_on, ticks)
            if tele is False:
                raise AssertionError(f"robustness: {proto} {name}: the "
                                     "phase marks do not explain the "
                                     "row's latency")
            checked += tele is True
        if checked < len(on) // 2:
            raise AssertionError(f"robustness: {proto}: only {checked} of "
                                 f"{len(on)} points committed a batch")
        i = names.index(f"{rates[-1]:.0f}/paper-ddos")
        trace = export.chrome_trace(on[i], cfg_on, proto,
                                    scenario=lib["paper-ddos"])
        export.validate(trace)
        p_off = tick_profile("robustness", proto, None, 100, cfg=cfg_off,
                             spec=spec)
        p_on = tick_profile("robustness", proto, None, 100, cfg=cfg_on,
                            spec=spec)
        per = lambda p, k: p[k] if p else float("nan")  # noqa: E731
        merged = monitor.merge_verdicts([monitor.verdict(r) for r in on])
        log("robustness", f"{proto} {len(on)} lanes x {ticks} ticks, "
                          f"{monitor.format_verdict(merged)}; "
                          f"telemetry off / on: wall {wall_off!r} / "
                          f"{wall_on!r} s, ms/tick "
                          f"{wall_off / ticks * 1e3!r} / "
                          f"{wall_on / ticks * 1e3!r}, launches/tick "
                          f"{per(p_off, 'launches_per_tick')!r} / "
                          f"{per(p_on, 'launches_per_tick')!r}, busy share "
                          f"{per(p_off, 'busy_share')!r} / "
                          f"{per(p_on, 'busy_share')!r}; metrics bitwise "
                          f"equal; phase marks explain the latency on "
                          f"{checked} points; "
                          f"{len(trace['traceEvents'])} trace events at "
                          f"{names[i]} validate")
        robust[proto] = {"wall_off_s": wall_off, "wall_on_s": wall_on,
                         "ms_per_tick_off": wall_off / ticks * 1e3,
                         "ms_per_tick_on": wall_on / ticks * 1e3,
                         "launches": l_on["channel_ring_commit"],
                         "graph_launches":
                             l_on["channel_ring_commit_graph"],
                         "capture_s_off": l_off["_programs"]["capture_s"],
                         "capture_s_on": l_on["_programs"]["capture_s"],
                         "profile_off": p_off, "profile_on": p_on}
    out["robustness"] = robust
    log("time", f"workloads (c) {time.perf_counter() - t_part!r} s")


# ---------------------------------------------------------------------------
# phase 16: reduced sweeps (run_sweep(..., mesh=)), the on-device latency
# sketch and its bucket-sum kernel
# ---------------------------------------------------------------------------

# the scalars of a row the reduced path must keep bit for bit
REDUCED_SCALARS = ("throughput", "median_ms", "p99_ms", "committed")
# the reference test's band between the sketch's median and the exact one
# (tests/test_sharded.py: pytest.approx(rel=0.1))
SKETCH_MEDIAN_REL = 0.1
# the bucket sums against index_add_ on the card, relative: the atomics add
# a bucket's terms in another order, each add rounding by half an ulp
# (2^-24), over at most a few hundred nonzero terms a bucket
SKETCH_CARD_REL = 1e-4


def row_bytes(row: dict) -> int:
    """Bytes a row carries back from the device: its arrays' and its
    numeric scalars' (float32 / int32, 4 bytes each)."""
    import numpy as np
    total = 0
    for k, v in row.items():
        if isinstance(v, dict):
            total += row_bytes(v)
        elif isinstance(v, np.ndarray):
            total += v.nbytes
        elif isinstance(v, (int, float)) and k not in ("rate", "seed"):
            total += 4
    return total


class _CaptureBuckets:
    """Keeps a copy of the inputs of every bucket-sum launch the sketch
    makes while active (the wrapper still launches and counts)."""

    def __enter__(self):
        from repro_torch.kernels.sketch_buckets import kernel
        self.kernel, self.orig, self.calls = kernel, \
            kernel.bucket_sums_cuda, []

        def capture(b, w, wv, bins):
            self.calls.append((b.clone(), w.clone(), wv.clone(), bins))
            return self.orig(b, w, wv, bins)

        kernel.bucket_sums_cuda = capture
        return self

    def __exit__(self, *exc):
        self.kernel.bucket_sums_cuda = self.orig


def sketch_bound_ms(b, w) -> float:
    """Least time of one bucket-sum launch on these inputs: w and wv read
    once (8 bytes an entry), each (lane, bucket)'s two binary searches of
    b (4 bytes a probe) and its two sums written (8 bytes), at 3.35 TB/s.
    The adds (two a nonzero entry) are a few thousand operations."""
    lanes, m = b.shape
    bins = 64
    probes = 2 * math.ceil(math.log2(m + 1))
    nbytes = 8 * lanes * m + lanes * bins * (4 * probes + 8)
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_sketch_kernel(call, tag: str) -> dict:
    """One captured launch's inputs: the kernel against its plain version
    on the CPU (bit for bit: both add in index order) and on the card
    (index_add_ by atomics: within SKETCH_CARD_REL of the sums), then the
    kernel's, the plain version's and one index_add_'s times."""
    import torch
    from repro_torch.kernels.sketch_buckets import kernel
    from repro_torch.kernels.sketch_buckets.ref import bucket_sums_ref

    b, w, wv, bins = call
    lanes, m = b.shape
    got = kernel.bucket_sums_cuda(b, w, wv, bins)
    cpu = bucket_sums_ref(b.cpu(), w.cpu(), wv.cpu(), bins)
    card = bucket_sums_ref(b, w, wv, bins)
    # torch's max keeps a NaN; the sums of finite terms must be finite
    err_cpu = float(torch.cat([(g.cpu() - c).abs().reshape(-1)
                               for g, c in zip(got, cpu)]).max())
    if not math.isfinite(err_cpu):
        raise AssertionError(f"{tag}: sketch bucket sums not finite")
    err = 0.0
    for g, c, a in zip(got, cpu, card):
        g = g.cpu()
        if not torch.equal(g.view(torch.int32), c.view(torch.int32)):
            raise AssertionError(f"{tag}: sketch bucket sums differ from "
                                 "the plain version on the CPU")
        err = max(err, float((g - a.cpu()).abs().max()))
        rel = float(((g - a.cpu()).abs() / c.abs().clamp(min=1e-30))
                    .max())
        if rel > SKETCH_CARD_REL:
            raise AssertionError(f"{tag}: kernel vs index_add_ on the card "
                                 f"{rel} relative")
    flat = (b.long() + bins * torch.arange(lanes, device=b.device)[:, None]
            ).reshape(-1)
    src = torch.stack([w.reshape(-1), wv.reshape(-1)], dim=1)
    acc = torch.zeros(lanes * bins, 2, device=b.device)
    ms = device_ms(lambda: kernel.bucket_sums_cuda(b, w, wv, bins))
    plain_ms = device_ms(lambda: bucket_sums_ref(b, w, wv, bins))
    lib_ms = device_ms(lambda: acc.zero_().index_add_(0, flat, src))
    nonzero = int((w != 0).sum())
    bound = sketch_bound_ms(b, w)
    log("reduced", f"{tag}: sketch_buckets [{lanes}, {m}] ({nonzero} "
                   f"nonzero weights): kernel == plain on the CPU bit for "
                   f"bit; vs index_add_ on the card max abs {err!r}; "
                   f"{ms!r} ms per launch (bound {bound!r} ms, bytes), "
                   f"plain {plain_ms!r} ms, index_add_ {lib_ms!r} ms")
    return {"shape": [lanes, m], "nonzero": nonzero, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "max_abs_err": err_cpu, "max_abs_err_card_plain": err}


def phase_reduced(results: dict) -> None:
    """(a) the mandator-sporades Fig-6 grid and (b) the multipaxos one
    through run_sweep(..., mesh=1) against phases 4 and 6b's unreduced
    rows; (c) the sketch on the card against the CPU; (d) grid_mesh past
    the card count raises."""
    import numpy as np
    import torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import harness
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import sketch
    from repro_torch.scenarios import library

    out = results.setdefault("reduced", {})
    cfg = SMRConfig()
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    full_walls = {"mandator-sporades": results["wall_s"],
                  "multipaxos": results["protocols"]["multipaxos"]["wall_s"]}
    for part, (proto, rates) in zip("ab", (
            ("mandator-sporades", FIG6_RATES),
            ("multipaxos", PAXOS_FIG6["multipaxos"]))):
        spec = SweepSpec(rates=rates, seeds=FIG6_SEEDS)
        with _CaptureBuckets() as cap:
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            rows = run_sweep(proto, cfg, spec, mesh=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
        full = results["fig6_rows"][proto]
        leaves = REDUCED_SCALARS + (("async_frac", "views")
                                    if proto == "mandator-sporades" else ())
        names = [f"{r['rate']:.0f}/{r['seed']}" for r in rows]
        _assert_same(rows, full, names, f"({part}) {proto} reduced vs "
                     "unreduced", leaves, same_keys=False)
        for r, name in zip(rows, names):
            dropped = set(harness.REDUCED_DROPS) & set(r)
            if dropped:
                raise AssertionError(f"({part}) {proto} {name}: reduced row "
                                     f"carries {sorted(dropped)}")
            for k in ("v", "w"):
                if r["sketch"][k].shape != (sketch.SKETCH_BINS,):
                    raise AssertionError(f"({part}) {proto} {name}: sketch "
                                         f"{k} {r['sketch'][k].shape}")
        _check_launches(proto, counts, ticks, f"({part}) reduced")
        if counts["sketch_buckets"] != 1 or len(cap.calls) != 1:
            raise AssertionError(f"({part}) {proto}: expected 1 "
                                 f"sketch_buckets launch, got {counts}")
        red_b = statistics.mean(row_bytes(r) for r in rows)
        full_b = statistics.mean(row_bytes(r) for r in full)
        meds = [sketch.quantile_np(r["sketch"]["v"], r["sketch"]["w"], 0.5)
                for r in rows]
        log("reduced", f"({part}) {proto} Fig-6 grid through "
                       f"run_sweep(mesh=1): {len(rows)} lanes x {ticks} "
                       f"ticks: wall {wall!r} s, {wall / ticks * 1e3!r} "
                       f"ms/tick (unreduced {full_walls[proto]!r} s, "
                       f"{full_walls[proto] / ticks * 1e3!r} ms/tick); "
                       f"{_graph_line(counts)}, "
                       f"{counts['sketch_buckets']} "
                       f"sketch_buckets; {', '.join(leaves)} bitwise equal "
                       f"to the unreduced rows; bytes read back per row "
                       f"{red_b!r} reduced, {full_b!r} unreduced; sketch "
                       "medians vs exact: " + ", ".join(
                           f"{m!r}/{r['median_ms']!r}"
                           for m, r in zip(meds, rows)))
        out[proto] = {"wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
                      "unreduced_wall_s": full_walls[proto],
                      "launches": counts, "row_bytes": red_b,
                      "unreduced_row_bytes": full_b,
                      "kernel": check_sketch_kernel(cap.calls[0],
                                                    f"({part}) {proto}")}

    # (c) the sketch on the card against the CPU, 1 s of baseline and
    # leader-crash-recover at 100k tx/s from one arrival table
    names = ("baseline", "leader-crash-recover")
    cfg = SMRConfig(sim_seconds=1.0)
    spec = SweepSpec(rates=(100_000,), scenarios=tuple(
        library.get(x, cfg.sim_seconds) for x in names))
    rng = np.random.RandomState(0)
    draws = rng.poisson(20.0, (len(names), 1000, 5)).astype(np.float32)
    card = run_sweep("mandator-sporades", cfg, spec, draws=draws, mesh=1)
    cpu = run_sweep("mandator-sporades", cfg, spec, draws=draws,
                    mesh=[torch.device("cpu")])
    _assert_same(card, cpu, names, "(c) sketch card vs cpu",
                 REDUCED_SCALARS + ("async_frac", "views"))
    gaps = []
    for r, c, name in zip(card, cpu, names):
        for k in ("v", "w"):
            a, b = (np.asarray(x["sketch"][k], np.float32).view(np.uint32)
                    for x in (r, c))
            if not np.array_equal(a, b):
                raise AssertionError(f"(c) {name}: sketch {k} differs, card "
                                     "vs CPU")
        med = sketch.quantile_np(r["sketch"]["v"], r["sketch"]["w"], 0.5)
        p99 = sketch.quantile_np(r["sketch"]["v"], r["sketch"]["w"], 0.99)
        gap = (med - r["median_ms"]) / r["median_ms"]
        gap99 = (p99 - r["p99_ms"]) / r["p99_ms"]
        log("reduced", f"(c) {name} 1 s @100k: sketch v, w bitwise equal "
                       f"card vs CPU; median {r['median_ms']!r} ms, sketch "
                       f"{med!r} (gap {gap!r}, band {SKETCH_MEDIAN_REL}); "
                       f"p99 {r['p99_ms']!r}, sketch {p99!r} (gap "
                       f"{gap99!r}, no band)")
        if not abs(gap) <= SKETCH_MEDIAN_REL:
            raise AssertionError(f"(c) {name}: sketch median {med} off the "
                                 f"exact {r['median_ms']}")
        gaps.append({"scenario": name, "median_gap": gap, "p99_gap": gap99})
    out["sketch_vs_exact"] = gaps

    # (d) no silent CPU and no phantom card
    n_dev = torch.cuda.device_count()
    try:
        dmesh.grid_mesh(n_dev + 1)
    except ValueError as e:
        log("reduced", f"(d) grid_mesh({n_dev + 1}) on {n_dev} card(s) "
                       f"raises: {e}")
    else:
        raise AssertionError(f"grid_mesh({n_dev + 1}) did not raise")


# ---------------------------------------------------------------------------
# the model stack: RMSNorm and flash attention kernels, prefill, decode
# ---------------------------------------------------------------------------

# (rows, D, dtype, residual, w dtype, x offset in elements): the B=4 x
# S=2048 prefill and a B=4 decode step of smollm-135m, with float32 and
# with bfloat16 weights (the bf16 model keeps its norm weights in bf16);
# Jamba's and qwen1.5-110b's d_model 8192 (a [2, 2048] prefill and a
# decode step); a D of 100, which no 16-byte vector of bf16 divides; and x
# views that start 4 and 6 bytes past a 16-byte boundary; musicgen-medium's
# d_model 1536 (its [4, 2048] prefill in f32 and bf16, each with its own
# weights' dtype, plain and with the residual)
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
) + tuple((8192, 1536, dt, res, dt, 0) for dt in ("float32", "bfloat16")
          for res in (False, True))
RMS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# (name, B, S, H, Kh, D, causal, dtype); at D 64 and 128 the bfloat16
# cases run the bf16 tensor-core kernel, the float32 ones the 3xTF32
# tensor-core kernel; musicgen-medium's prefill is MHA, a GQA group of 1
FLASH_CASES = (
    ("smollm-prefill", 4, 2048, 9, 3, 64, True, "float32"),
    ("smollm-prefill-bf16", 4, 2048, 9, 3, 64, True, "bfloat16"),
    ("ragged-S1000", 4, 1000, 9, 3, 64, True, "float32"),
    ("qwen3-14b-D128", 1, 2048, 40, 8, 128, True, "float32"),
    ("non-causal", 4, 512, 9, 3, 64, False, "float32"),
    ("qwen3-14b-D128-bf16", 1, 2048, 40, 8, 128, True, "bfloat16"),
    ("ragged-S1000-bf16", 4, 1000, 9, 3, 64, True, "bfloat16"),
    ("non-causal-bf16", 4, 512, 9, 3, 64, False, "bfloat16"),
    ("musicgen-prefill", 4, 2048, 24, 24, 64, True, "float32"),
    ("musicgen-prefill-bf16", 4, 2048, 24, 24, 64, True, "bfloat16"),
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
# decode steps timed and profiled again at the end (16 until PR 22)
DECODE_PROFILE_STEPS = 4


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


def flash_case(b, s, h, kh, d, causal, dtype) -> dict:
    """The flash kernel against its plain version at one model shape (it
    raises past FLASH_TOL or, in bf16, past its rounding twin's limit),
    with its time, its bound, the plain version's and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    err, order_err, excess, (q, k, v) = check_flash(b, s, h, kh, d, causal,
                                                    dtype)
    if not err <= FLASH_TOL[dtype] or (excess is not None
                                       and not excess <= 1):
        raise AssertionError(f"flash [{b}, {s}, {h}, {kh}, {d}] {dtype}: "
                             f"max abs err {err}, {excess} of its order "
                             "limit")
    bound_ms, bound_by, flops, nbytes = flash_bound(b, s, h, kh, d, causal,
                                                    dtype)
    out = {"shape": [b, s, h, kh, d], "causal": causal, "dtype": dtype,
           "max_abs_err": err, "order_err": order_err,
           "order_excess": excess, "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "ms": device_ms(cycling(lambda q, k, v: fk.flash_attention_cuda(
               q, k, v, causal=causal), (q, k, v), nbytes), reps=10,
               rounds=5),
           "plain_ms": device_ms(cycling(lambda q, k, v: fref.attention_ref(
               q, k, v, causal=causal), (q, k, v), nbytes), reps=3,
               rounds=3),
           "library_ms": device_ms(cycling(
               lambda q, k, v: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   is_causal=causal, enable_gqa=True), (q, k, v), nbytes),
               reps=10, rounds=5)}
    del q, k, v
    torch.cuda.empty_cache()
    return out


def rms_case(n, d, dtype, w_dtype) -> dict:
    """The RMSNorm kernel against its plain version on x [n, d] (no
    residual; it raises past RMS_TOL), with its time, its bound, the
    plain version's and F.rms_norm's (where w has x's dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rref
    err, (x, w, r) = check_rmsnorm(n, d, dtype, False, w_dtype)
    if not err <= RMS_TOL[dtype]:
        raise AssertionError(f"rmsnorm [{n}, {d}] {dtype}: {err}")
    nbytes = 2 * n * d * x.element_size() + d * w.element_size()
    out = {"shape": [n, d], "dtype": dtype, "w_dtype": w_dtype,
           "max_abs_err": err, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes": nbytes,
           "ms": device_ms(cycling(lambda x, w, _: rk.rmsnorm_cuda(x, w),
                                   (x, w, r), nbytes)),
           "plain_ms": device_ms(cycling(lambda x, w, _: rref.rmsnorm_ref(
               x, w), (x, w, r), nbytes)),
           "library_ms": (device_ms(cycling(lambda x, w, _: F.rms_norm(
               x, (d,), w, 1e-5), (x, w, r), nbytes))
               if w.dtype == x.dtype else None)}
    del x, w, r
    torch.cuda.empty_cache()
    return out


def log_case(phase: str, name: str, c: dict) -> None:
    log(phase, f"{name} {c['shape']} {c['dtype']}: max abs err "
               f"{c['max_abs_err']!r}, kernel {c['ms']!r} ms, plain "
               f"{c['plain_ms']!r} ms, library {c['library_ms']!r} ms, "
               f"bound {c['bound_ms']!r} ms by {c['bound_by']}")


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
    from repro_torch.kernels.sketch_buckets import kernel as bk
    from repro_torch.kernels.ssm_scan import kernel as sk
    return {"channel_ring_commit": ck, "rmsnorm": rk, "flash_attention": fk,
            "ssm_scan": sk, "decode_attention": dk, "sketch_buckets": bk}


_PROGRAM_TOTALS: dict = {}


def _reset_counts():
    """Every wrapper's launch count, and the tick programs' accounting
    (core/compile_cache.py), to 0; the accounting so far is added to
    ``_PROGRAM_TOTALS`` first."""
    from repro_torch.core import compile_cache
    for k, v in compile_cache.stats().items():
        _PROGRAM_TOTALS[k] = _PROGRAM_TOTALS.get(k, 0) + v
    for k in _kernel_modules().values():
        if hasattr(k, "route_counts"):    # flash: launch_count is their sum
            k.route_counts.update(dict.fromkeys(k.route_counts, 0))
        else:
            k.launch_count = 0
    compile_cache.reset_stats()


def _counts() -> dict:
    """Each wrapper's launches since the last reset, plus the commit
    kernel's launches by the tick graphs' replays (``_graph``) and the
    programs' accounting (``_programs``): on the card a wrapper launches
    its kernel for a run's eager warm-up tick and once into the graph it
    captures; the replays launch the graph's kernel nodes."""
    from repro_torch.core import compile_cache
    out = {name: k.launch_count for name, k in _kernel_modules().items()}
    out["channel_ring_commit_graph"] = compile_cache.graph_kernel_launches(
        COMMIT_KERNEL)
    out["_programs"] = compile_cache.stats()
    return out


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

    # the last positions again (the cache already holds them; the mask at
    # kv_len = t + 1 makes each step see what it saw the first time)
    window = range(DECODE_STEPS - DECODE_PROFILE_STEPS, DECODE_STEPS)
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
# dropped S-split moves them by ~0.02). musicgen-medium's MHA decode (a
# GQA group of 1: one useful head of a block of 8 in the float32 kernel)
# takes the rules of its S = 2048: 5e-6 and SmolLM's 8e-3
DECODE_CASES = (
    ("smollm-decode", 4, 9, 3, 64, 2048, SMOLLM_LENS, "float32", 5e-6),
    ("smollm-decode-bf16", 4, 9, 3, 64, 2048, SMOLLM_LENS, "bfloat16",
     8e-3),
    ("qwen3-14b-full", 8, 40, 8, 128, 8192, None, "float32", 1e-5),
    ("qwen3-14b-full-bf16", 8, 40, 8, 128, 8192, None, "bfloat16", 4e-3),
    ("qwen3-14b-ragged", 8, 40, 8, 128, 8192, QWEN_LENS, "float32", 1e-5),
    ("qwen3-14b-ragged-bf16", 8, 40, 8, 128, 8192, QWEN_LENS, "bfloat16",
     8e-3),
    ("musicgen-full", 4, 24, 24, 64, 2048, None, "float32", 5e-6),
    ("musicgen-full-bf16", 4, 24, 24, 64, 2048, None, "bfloat16", 8e-3),
    ("musicgen-ragged", 4, 24, 24, 64, 2048, SMOLLM_LENS, "float32", 5e-6),
    ("musicgen-ragged-bf16", 4, 24, 24, 64, 2048, SMOLLM_LENS, "bfloat16",
     8e-3))
# each decode kernel against its twin at the kernel's split plan, element
# by element, max abs. bfloat16 (decode_attention_kernel_order): about 4x
# the largest gap read on an H100 (2^-12 at SmolLM's decode and qwen3-14b's
# ragged kv_len, 2^-13 at its full cache). float32
# (decode_attention_tf32x3_order): flash's limit for its 3xTF32 twin
DECODE_ORDER_TOL = {"bfloat16": 1e-3, "float32": TF32X3_ORDER_TOL}
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
                          f"{nbytes / ms / 1e9!r} TB/s); copies alone "
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


def decode_order(q, k, v, kv_len):
    """The decode kernel's twin on these CUDA inputs, at the kernel's own
    split plan and ring stage: decode_attention_kernel_order in bfloat16,
    decode_attention_tf32x3_order in float32."""
    import torch
    from repro_torch.kernels.decode_attention import kernel, ref
    _, chunk = kernel.plan(q, k)
    tile = kernel.stage()
    if q.dtype == torch.bfloat16:
        return ref.decode_attention_kernel_order(q, k, v, kv_len,
                                                 chunk=chunk, tile=tile)
    return ref.decode_attention_tf32x3_order(q, k, v, kv_len, chunk=chunk,
                                             tile=tile)


def check_decode(b, h, kh, d, s, lens, dtype):
    """Kernel against plain version on one case. Returns (max abs err vs
    decode_attention_ref, max abs err vs the kernel's twin at its split
    plan (decode_order), inputs)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel, ref
    inputs = decode_inputs(b, h, kh, d, s, lens, dtype)
    out = kernel.decode_attention_cuda(*inputs)
    want = ref.decode_attention_ref(*inputs)
    order = decode_order(*inputs)
    torch.cuda.synchronize()
    if out.dtype != inputs[0].dtype or out.shape != inputs[0].shape:
        raise AssertionError(f"decode output {out.dtype} {out.shape}")
    err = (out.float() - want.float()).abs().max().item()
    order_err = (out.float() - order.float()).abs().max().item()
    return err, order_err, inputs


def oracle_err(out, q, k, v, kv_len) -> float:
    """Max abs error of ``out`` against decode_attention_ref in float64."""
    from repro_torch.kernels.decode_attention import ref
    want = ref.decode_attention_ref(q.double(), k.double(), v.double(),
                                    kv_len)
    return (out.double() - want).abs().max().item()


def decode_bound(b, h, kh, d, s, lens, dtype):
    """(bound ms, what bounds it, flops, bytes): K and V read up to each
    sequence's kv_len, q read and out written, once, at 3.35 TB/s; 4*D
    flops per (query head, visible key), on the tensor cores: in float32
    three TF32 products for each (3xTF32) at the TF32 peak, in bfloat16 at
    the bf16 peak."""
    es = 4 if dtype == "float32" else 2
    keys = sum(min(n, s) for n in lens) if lens is not None else b * s
    nbytes = es * (2 * keys * kh * d + 2 * b * h * d) + 4 * b
    flops = 4 * d * (h // kh) * kh * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == "float32":
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
        order_tol = DECODE_ORDER_TOL[dtype]
        if not order_err <= order_tol:
            raise AssertionError(f"decode {name}: kernel vs its twin "
                                 f"{order_err} > {order_tol}")
        if not err <= tol:
            raise AssertionError(f"decode {name}: kernel vs plain {err} > "
                                 f"{tol}")
        splits, chunk = kernel.plan(q, k)
        plan = {"splits": splits, "chunk": chunk,
                "tile": kernel.stage(),
                "ctas_per_sm": kernel.ctas_per_sm(q.dtype, d, h // kh, 0)}
        valid = (torch.arange(s, device="cuda")[None, :]
                 < kv_len[:, None].long())
        sdpa = F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid[:, None, None, :],
            enable_gqa=True)[:, :, 0]
        want = ref.decode_attention_ref(q, k, v, kv_len)
        sdpa_err = (sdpa.float() - want.float()).abs().max().item()
        err64 = None
        if dtype == "float32":
            err64 = oracle_err(kernel.decode_attention_cuda(q, k, v, kv_len),
                               q, k, v, kv_len)
        bound_ms, bound_by, flops, nbytes = decode_bound(b, h, kh, d, s,
                                                         lens, dtype)
        ms = device_ms(cycling(kernel.decode_attention_cuda,
                               (q, k, v, kv_len), nbytes), reps=20, rounds=5)
        # the memory path's share: the float32 kernel's copies alone
        loads_ms = None
        if dtype == "float32":
            loads_ms = device_ms(cycling(kernel.decode_attention_loads_cuda,
                                         (q, k, v, kv_len), nbytes),
                                 reps=20, rounds=5)
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
                      "order_err": order_err, "order_tol": order_tol,
                      "oracle_err": err64, "sdpa_vs_plain": sdpa_err,
                      "ms": ms, "loads_only_ms": loads_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "flops": flops, "bytes": nbytes, "plan": plan,
                      "kernel": ("decode_tf32_kernel" if dtype == "float32"
                                 else "decode_bf16_kernel")})
        log("decode kernel", f"{name} B={b} H={h} Kh={kh} D={d} S={s} "
                             f"{dtype}: plan {plan}, max abs err {err!r} "
                             f"(tol {tol}; sdpa vs plain {sdpa_err!r}; vs "
                             f"its twin {order_err!r}, tol {order_tol}; vs "
                             f"a float64 oracle {err64!r}), kernel {ms!r} "
                             f"ms ({nbytes / ms / 1e9!r} TB/s), copies "
                             f"alone {loads_ms!r} ms, plain {plain_ms!r} "
                             f"ms, sdpa {library_ms!r} ms, bound "
                             f"{bound_ms!r} ms by {bound_by} ({nbytes} "
                             f"bytes)")
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


# ---------------------------------------------------------------------------
# slice 12: training (phase 17) and MoE at dbrx-132b's widths (phase 18)
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_B, TRAIN_S = 20, 8, 512   # phase 17 (a), smollm-135m
# phase 17 (b): card against CPU, reduced configs, int8 moments on
TRAIN_PARITY_ARCHS = ("smollm-135m", "jamba-1.5-large-398b", "xlstm-1.3b",
                      "llama-3.2-vision-11b")
TRAIN_PARITY_STEPS = 5
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_TOL = 1e-5
# xLSTM's steps diverge from rounding alone (phase 19; ROADMAP Queue C):
# its card-vs-CPU limits are FLOOR_FACTOR times the CPU's own divergence
# from the same steps with every embedding entry one ulp off, where that
# is larger
TRAIN_FLOOR_ARCHS = ("xlstm-1.3b",)
# phase 18: dbrx-132b's published widths at this depth (a depth cut)
MOE_ARCH, MOE_DEPTH = "dbrx-132b", 2
MOE_B, MOE_S = 4, 1024                       # the prefill's tokens
MOE_PROMPT, MOE_GEN = 8, 32                  # greedy_generate at B = 4
MOE_LAYER_B, MOE_LAYER_S = 2, 1024           # one MoE layer, f32 vs f64
MOE_Y_REL = 1e-4


def _max_param_diff(a, b) -> float:
    return max((pa.detach().cpu().double() - pb.detach().cpu().double())
               .abs().max().item()
               for pa, pb in zip(a.parameters(), b.parameters()))


def phase_train(results: dict) -> None:
    """(a) launch.train.train at smollm-135m's full width on the card;
    (b) make_train_step on the card against the CPU, reduced configs;
    (c) a backward through each kernel route raises."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import CallConfig, init_params, loss_fn, ssm
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    # (a) the trainer at full width: dense attention in float32, no remat,
    # AdamW(lr 1e-3, 20 warm-up steps), one pod, Sporades commits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = train("smollm-135m", reduced=False, steps=TRAIN_STEPS,
                batch=TRAIN_B, seq=TRAIN_S, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses, secs, commits = out["losses"], out["step_seconds"], \
        out["commits"]
    steady = statistics.median(secs[2:])
    n_tok = TRAIN_B * TRAIN_S
    n_params = sum(p.numel() for p in out["params"].parameters())
    log("train", f"smollm-135m full width ({n_params} params, 30 layers, "
                 f"d 576), {TRAIN_STEPS} steps of [{TRAIN_B}, {TRAIN_S}] "
                 f"f32 dense: {wall!r} s in all; step walls {secs!r} s; "
                 f"median of steps 2-19 {steady!r} s = {n_tok / steady!r} "
                 f"tokens/s; peak memory {peak} B; losses {losses!r}; "
                 f"commits {commits}; kernel launches {counts}")
    # one more step of the trained model, timed and profiled
    cfg = get_config("smollm-135m")
    step = make_train_step(cfg, CallConfig(compute_dtype=torch.float32,
                                           attention_impl="dense",
                                           remat=False),
                           AdamWConfig(lr=1e-3, warmup_steps=20))
    state = [out["params"], out["opt_state"]]
    batch = global_batch(cfg, ShapeConfig("t", "train", TRAIN_S, TRAIN_B),
                         DataConfig(), TRAIN_STEPS)

    def one_step():
        state[0], state[1], m = step(state[0], state[1], batch)
        return m

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    launches, dev_ms, top = _profile_window(one_step, 1)
    del out, state
    torch.cuda.empty_cache()
    prof = {"step_wall_s": step_wall, "launches": launches,
            "device_ms": dev_ms,
            "busy_share": dev_ms / (step_wall * 1e3) if dev_ms else None}
    log("train", f"one more step: {step_wall!r} s untraced; profiled "
                 f"{launches!r} kernel launches, device busy {dev_ms!r} ms "
                 f"(busy share {prof['busy_share']!r})")
    for e in top:
        log("train", f"  {e.self_device_time_total / 1e3!r} ms x{e.count}"
                     f"  {e.key[:90]}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]} not below the "
                             f"first {losses[0]}")
    if commits != [TRAIN_STEPS]:
        raise AssertionError(f"train: Sporades committed {commits} of "
                             f"{TRAIN_STEPS} steps")
    results["train"] = {"wall_s": wall, "step_s": secs,
                        "median_step_s": steady,
                        "tokens_per_s": n_tok / steady, "peak_bytes": peak,
                        "losses": losses, "params": n_params,
                        "commits": commits, "launches": counts,
                        "profile": prof}

    # (b) card against CPU: one parameter set, the same batches
    parity = {}
    for arch in TRAIN_PARITY_ARCHS:
        cfg = get_config(arch).reduced()
        opt = AdamWConfig(lr=1e-3, warmup_steps=20, quantized_state=True)
        step = make_train_step(cfg, CallConfig(
            compute_dtype=torch.float32, attention_impl="dense",
            remat=False), opt)
        cpu = init_params(cfg, 0, device="cpu")
        card = copy.deepcopy(cpu).cuda()
        st_cpu, st_card = init_opt_state(opt, cpu), init_opt_state(opt, card)
        floor = arch in TRAIN_FLOOR_ARCHS
        if floor:
            nud = copy.deepcopy(cpu)
            nud.embed.data = _nudged_embed(cpu)
            st_nud = init_opt_state(opt, nud)
        shape = ShapeConfig("t", "train", 64, 4)
        rels, nud_rels = [], []
        for i in range(TRAIN_PARITY_STEPS):
            b = global_batch(cfg, shape, DataConfig(), i, device="cpu")
            cpu, st_cpu, m_cpu = step(cpu, st_cpu, b)
            card, st_card, m_card = step(card, st_card,
                                         {k: v.cuda() for k, v in b.items()})
            lc, lg = m_cpu["loss"].item(), m_card["loss"].item()
            rels.append(abs(lg - lc) / abs(lc))
            if floor:
                nud, st_nud, m_nud = step(nud, st_nud, b)
                nud_rels.append(abs(m_nud["loss"].item() - lc) / abs(lc))
        diff = _max_param_diff(card, cpu)
        loss_lim, param_lim = TRAIN_LOSS_REL, TRAIN_PARAM_TOL
        parity[arch] = {"loss_rel": rels, "param_max_abs": diff}
        if floor:
            nud_diff = _max_param_diff(nud, cpu)
            loss_lim = max(loss_lim, FLOOR_FACTOR * max(nud_rels))
            param_lim = max(param_lim, FLOOR_FACTOR * nud_diff)
            parity[arch].update(cpu_one_ulp_loss_rel=nud_rels,
                                cpu_one_ulp_param_max_abs=nud_diff)
        parity[arch].update(loss_limit=loss_lim, param_limit=param_lim)
        log("train", f"(b) {cfg.name}: {TRAIN_PARITY_STEPS} steps card vs "
                     f"CPU, int8 moments on: loss relative diffs {rels!r}, "
                     f"params max abs diff {diff!r} (limits {loss_lim!r}, "
                     f"{param_lim!r}"
                     + (f": {FLOOR_FACTOR}x the CPU's own divergence with "
                        f"the embeddings one ulp off, loss {nud_rels!r}, "
                        f"params {nud_diff!r}" if floor else "") + ")")
        if not max(rels) <= loss_lim or not diff <= param_lim:
            raise AssertionError(f"train card vs CPU {arch}: {parity[arch]}")
    results["train"]["card_vs_cpu"] = parity

    # (c) the kernel routes refuse autograd on the card
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, 0)
    tok = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    jcfg = get_config("jamba-1.5-large-398b").reduced()
    mixer = init_params(jcfg, 0).layers[0].mixer
    refused = []
    for route, fn in (
            ("pallas attention", lambda: loss_fn(params, cfg, CallConfig(
                compute_dtype=torch.float32, attention_impl="pallas",
                remat=False), {"tokens": tok, "labels": tok})),
            ("pallas norm", lambda: loss_fn(params, cfg, CallConfig(
                compute_dtype=torch.float32, use_pallas_norm=True,
                remat=False), {"tokens": tok, "labels": tok})),
            ("ssm_scan", lambda: ssm.mamba_forward(
                mixer, torch.randn((1, 16, jcfg.d_model), device="cuda"),
                cfg=jcfg, use_kernel=True))):
        try:
            fn()
        except NotImplementedError as e:
            refused.append(route)
            log("train", f"(c) backward through {route} refused: "
                         f"{str(e)[:60]}...")
        else:
            raise AssertionError(f"a backward through {route} did not raise")
    results["train"]["refused"] = refused


def phase_moe(results: dict) -> None:
    """dbrx-132b at its published widths, depth MOE_DEPTH, bf16: (a) the
    prefill with the flash and RMSNorm kernels (each held against its plain
    version at these shapes); (b) greedy_generate; (c) one MoE layer in
    float32 against the same function in float64."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import (CallConfig, forward_train, init_cache,
                                    init_params, moe, param_count_actual)
    from repro_torch.models.layers import Weights

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_DEPTH)
    bf16 = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dtype=bf16)
    n_params = param_count_actual(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), generator=gen,
                           device="cuda")
    call = CallConfig(compute_dtype=bf16, attention_impl="pallas",
                      use_pallas_norm=True, remat=False)
    plain = dataclasses.replace(call, kernel_backend="ref")
    batch = {"tokens": tokens}
    out = {"params": n_params, "depth": MOE_DEPTH}

    # (a) the prefill; each MoE layer's top-k kept, to count the tokens
    # the kernels' path routes otherwise than the plain path (bf16 router
    # logits tie often: a last-bit difference upstream moves a token)
    topis: list = []
    route = moe.route

    def recorded(*a, **kw):
        r = route(*a, **kw)
        topis.append(r["topi"].sort(dim=-1).values)
        return r

    with torch.no_grad():
        forward_train(params, cfg, call, batch)              # first calls
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        logits, aux = forward_train(params, cfg, call, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        routes = dict(fk.route_counts)
        t0 = time.perf_counter()
        logits_plain, _ = forward_train(params, cfg, plain, batch)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        launches, dev_ms, top = _profile_window(
            lambda: forward_train(params, cfg, call, batch), 1)
        moe.route = recorded
        try:
            forward_train(params, cfg, call, batch)
            forward_train(params, cfg, plain, batch)
        finally:
            moe.route = route
    flips = [int((a != b).any(-1).sum())
             for a, b in zip(topis[:MOE_DEPTH], topis[MOE_DEPTH:])]
    err = (logits - logits_plain).abs().amax(dim=-1)
    diff, scale = err.max().item(), logits_plain.abs().max().item()
    far = int((err > 0.1).sum())
    del logits_plain, err
    n_tok = MOE_B * MOE_S
    log("moe", f"{MOE_ARCH} published widths at depth {MOE_DEPTH} "
               f"({n_params} params, bf16), prefill [{MOE_B}, {MOE_S}]: "
               f"kernels {wall!r} s = {n_tok / wall!r} tokens/s; plain "
               f"versions {wall_plain!r} s; logits kernels vs plain max abs "
               f"{diff!r} (max |logit| {scale!r}), {far} of {n_tok} "
               f"positions off by more than 0.1; tokens routed otherwise "
               f"by the two paths, by layer: {flips}; aux {aux.item()!r}; "
               f"launches {counts}, flash by kernel {routes}; one forward "
               f"profiled: {launches!r} kernel launches, device busy "
               f"{dev_ms!r} ms")
    for e in top:
        log("moe", f"  {e.self_device_time_total / 1e3!r} ms x{e.count}  "
                   f"{e.key[:90]}")
    if not torch.isfinite(logits).all() or \
            tuple(logits.shape) != (MOE_B, MOE_S, cfg.vocab):
        raise AssertionError(f"dbrx prefill logits {tuple(logits.shape)}")
    want_rms = 2 * MOE_DEPTH + 1
    if counts["flash_attention"] != MOE_DEPTH \
            or counts["rmsnorm"] != want_rms or routes["tc"] != MOE_DEPTH:
        raise AssertionError(f"expected {MOE_DEPTH} flash (tensor-core) and "
                             f"{want_rms} rmsnorm launches, got {counts} "
                             f"{routes}")
    del logits
    out["prefill"] = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                      "plain_wall_s": wall_plain, "logits_diff": diff,
                      "logits_scale": scale, "positions_off": far,
                      "routing_flips": flips, "launches": counts,
                      "flash_routes": routes, "profile_launches": launches,
                      "device_ms": dev_ms}

    # the kernels at the prefill's shapes against their plain versions
    fl = flash_case(MOE_B, MOE_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    True, "bfloat16")
    rms = rms_case(MOE_B * MOE_S, cfg.d_model, "bfloat16", "bfloat16")
    out["flash"], out["rmsnorm"] = fl, rms
    for name, c in (("flash", fl), ("rmsnorm", rms)):
        log_case("moe", f"{name} at dbrx's prefill shape", c)

    # (b) serving: the prompt fed token by token, then greedy decoding
    cache = init_cache(cfg, MOE_B, MOE_PROMPT + MOE_GEN, bf16)
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        toks, _ = greedy_generate(params, cfg, call,
                                  {"tokens": tokens[:, :MOE_PROMPT]}, cache,
                                  MOE_PROMPT, MOE_GEN)
        toks = toks.cpu()
        gen_wall = time.perf_counter() - t0
        gen_counts = _counts()
    n_steps = MOE_PROMPT + MOE_GEN - 1
    peak = torch.cuda.max_memory_allocated()
    log("moe", f"greedy_generate B={MOE_B} prompt {MOE_PROMPT} gen "
               f"{MOE_GEN}: {gen_wall!r} s, {gen_wall / n_steps * 1e3!r} "
               f"ms per decode step ({n_steps} steps), tokens "
               f"{tuple(toks.shape)}, first {toks[0, :8].tolist()}; "
               f"launches {gen_counts}; peak memory {peak} B")
    if tuple(toks.shape) != (MOE_B, MOE_GEN) or \
            not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"dbrx greedy_generate returned {toks.shape}")
    out["decode"] = {"wall_s": gen_wall, "steps": n_steps,
                     "ms_per_step": gen_wall / n_steps * 1e3,
                     "launches": gen_counts}
    out["peak_bytes"] = peak
    del params, cache
    torch.cuda.empty_cache()

    # (c) one MoE layer at full width, float32 against float64
    gen.manual_seed(3)
    p32 = moe.init_moe(cfg, gen, torch.float32, "cuda")
    # the float64 yardstick of the float32 layer
    p64 = Weights(**{n: t.detach().double() for n, t in
                     p32.named_parameters()})
    x = torch.randn((MOE_LAYER_B, MOE_LAYER_S, cfg.d_model), generator=gen,
                    device="cuda")
    with torch.no_grad():
        r32 = moe.route(p32, x, cfg=cfg)
        r64 = moe.route(p64, x.double(), cfg=cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y32, aux32 = moe.moe_mlp(p32, x, cfg=cfg)
        torch.cuda.synchronize()
        layer_wall = time.perf_counter() - t0
        y64, aux64 = moe.moe_mlp(p64, x.double(), cfg=cfg)
    flips = int((r32["topi"] != r64["topi"]).any(-1).sum())
    disp_same = bool(torch.equal(r32["disp"].double(), r64["disp"]))
    y_rel = ((y32.double() - y64).abs().max() / y64.abs().max()).item()
    log("moe", f"one MoE layer at full width (d {cfg.d_model}, "
               f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff "
               f"{cfg.moe.d_ff_expert}) on x [{MOE_LAYER_B}, {MOE_LAYER_S}]"
               f" f32 vs f64: tokens whose top-k differ {flips}, disp equal "
               f"{disp_same}, y max abs diff / max |y| {y_rel!r} (tol "
               f"{MOE_Y_REL}), aux {aux32.item()!r} vs {aux64.item()!r}; "
               f"f32 layer {layer_wall!r} s")
    if flips or not disp_same or not y_rel <= MOE_Y_REL:
        raise AssertionError(f"MoE layer f32 vs f64: {flips} tokens "
                             f"routed otherwise, disp equal {disp_same}, y "
                             f"{y_rel}")
    out["layer"] = {"flips": flips, "disp_equal": disp_same, "y_rel": y_rel,
                    "wall_s": layer_wall}
    del p32, p64, x, r32, r64, y32, y64
    torch.cuda.empty_cache()
    results["moe"] = out


# ---------------------------------------------------------------------------
# slice 13: xlstm-1.3b and llama-3.2-vision-11b at their published widths
# (phase 19)
# ---------------------------------------------------------------------------

XLSTM_ARCH, XLSTM_PARAMS = "xlstm-1.3b", 2_321_033_552
XLSTM_B, XLSTM_S = 4, 2048                   # the prefill's tokens
XLSTM_DECODE_FULL = 32                       # decode steps at full depth
XLSTM_PROFILE_STEPS = 128                    # sLSTM steps profiled
# the depth of the accuracy checks: one super-block, seven mLSTM layers and
# an sLSTM; deeper, float32 rounding alone moves the logits by O(1)
XLSTM_ACC_DEPTH = 8
VISION_ARCH, VISION_PARAMS = "llama-3.2-vision-11b", 10_110_734_336
VISION_B, VISION_S = 2, 2048                 # the prefill's tokens
VISION_PROMPT, VISION_GEN = 16, 32           # greedy_generate at B = 2
# the accuracy check's depth: one super-block, four self-attention layers
# and one with cross-attention (f32 at full depth would be 40 GB)
VISION_ACC_DEPTH = 5
# the kernels at the two prefills' shapes: (rows, D, dtype, w dtype) and
# (B, S, H, Kh, D, causal, dtype)
XV_RMS_CASES = ((XLSTM_B * XLSTM_S, 2048, "float32", "float32"),
                (XLSTM_B * XLSTM_S, 2048, "bfloat16", "bfloat16"),
                (VISION_B * VISION_S, 4096, "bfloat16", "bfloat16"))
XV_FLASH_CASE = (VISION_B, VISION_S, 32, 8, 128, True, "bfloat16")
# xLSTM amplifies float32 rounding (the mLSTM divides by a sum that
# cancels; tests/test_torch_xlstm.py, ROADMAP Queue C): where the plain
# path's own logits, run again with every embedding entry one ulp off,
# move by more than a limit allows, the limit becomes FLOOR_FACTOR times
# that move
FLOOR_FACTOR = 4


def _bf16_errors(logits, logits_plain, exact) -> dict:
    """Max and mean abs error of the kernels' and the plain path's bf16
    logits against a float32 forward of the same weights; raises unless
    the kernels' are at most LOGITS_BF16_RATIO times the plain path's."""
    errs = {}
    for name, out in (("kernels", logits), ("plain", logits_plain)):
        e = (out.float() - exact).abs()
        errs[name] = {"max": e.max().item(), "mean": e.mean().item()}
        del e
    for stat in ("max", "mean"):
        if not errs["kernels"][stat] <= \
                LOGITS_BF16_RATIO * errs["plain"][stat]:
            raise AssertionError(f"bf16 logits: the kernels' {stat} error vs "
                                 f"float32 {errs['kernels'][stat]} > "
                                 f"{LOGITS_BF16_RATIO} x the plain path's "
                                 f"{errs['plain'][stat]}")
    return errs


def _nudged_embed(params):
    """A copy of ``params.embed`` with every entry one ulp up or down."""
    import torch
    e = params.embed.detach()
    gen = torch.Generator(device=e.device)
    gen.manual_seed(7)
    up = torch.rand(e.shape, generator=gen, device=e.device) < 0.5
    toward = torch.where(up, float("inf"), float("-inf")).to(e.dtype)
    return torch.nextafter(e, toward)


def _spread(a, b) -> dict:
    d = (a - b).abs()
    return {"max": d.max().item(), "mean": d.mean().item()}


def phase_xlstm(results: dict) -> None:
    """xlstm-1.3b at full width: (a) at full depth, the [4, 2048] prefill
    in f32 and in bf16 with the RMSNorm kernel (walls, launches, peak
    memory), the wall split between the mLSTM and the sLSTM layers, and
    decode steps; (b) at depth XLSTM_ACC_DEPTH, kernels against plain
    logits, decode against the prefill over 256 positions and the bf16
    rule, each beside the plain path's one-ulp spread; (c) each mixer's
    recurrent form against its forward over 256 positions."""
    import copy
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (CallConfig, forward_decode, forward_train,
                                    init_cache, init_params,
                                    param_count_actual, ssm)
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import rms_norm

    cfg = get_config(XLSTM_ARCH)
    bf16 = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the same weights twice: drawn in bf16, and their values in float32
    # (the float32 forward is the bf16 prefill's yardstick)
    p16 = init_params(cfg, 0, dtype=bf16)
    p32 = copy.deepcopy(p16).float()
    n_params = param_count_actual(p32)
    if n_params != XLSTM_PARAMS:
        raise AssertionError(f"xlstm-1.3b has {n_params} params")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (XLSTM_B, XLSTM_S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    call32 = CallConfig(compute_dtype=torch.float32, attention_impl="pallas",
                        use_pallas_norm=True, remat=False)
    plain32 = dataclasses.replace(call32, kernel_backend="ref")
    call16 = dataclasses.replace(call32, compute_dtype=bf16)
    plain16 = dataclasses.replace(plain32, compute_dtype=bf16)
    want_rms = cfg.n_layers + 1            # norm1 a layer (no MLP), final
    n_tok = XLSTM_B * XLSTM_S
    out = {"params": n_params}

    def run(params, c, call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = forward_train(params, c, call, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    def nudged_run(params, c, call):
        """The logits with every embedding entry one ulp off."""
        kept = params.embed.data
        params.embed.data = _nudged_embed(params)
        try:
            return run(params, c, call)[1]
        finally:
            params.embed.data = kept

    with torch.no_grad():
        # (a) full depth
        warm = {"tokens": tokens[:, :cfg.ssm.chunk]}      # first calls
        for p, c in ((p32, call32), (p32, plain32), (p16, call16)):
            forward_train(p, cfg, c, warm)
        for name, params, call in (("f32", p32, call32),
                                   ("bf16", p16, call16)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            wall, logits = run(params, cfg, call)
            counts = _counts()
            peak = torch.cuda.max_memory_allocated()
            if not torch.isfinite(logits).all() or \
                    tuple(logits.shape) != (XLSTM_B, XLSTM_S, cfg.vocab):
                raise AssertionError(f"xlstm {name} prefill logits "
                                     f"{tuple(logits.shape)}")
            if counts["rmsnorm"] != want_rms or counts["flash_attention"]:
                raise AssertionError(f"xlstm {name} prefill: expected "
                                     f"{want_rms} rmsnorm launches and no "
                                     f"flash, got {counts}")
            rec = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                   "peak_bytes": peak, "launches": counts,
                   "logits_scale": logits.abs().max().item()}
            if name == "f32":
                rec["plain_wall_s"], exact = run(p32, cfg, plain32)
                rec["vs_plain"] = _spread(logits, exact)
                rec["one_ulp_spread"] = _spread(
                    nudged_run(p32, cfg, plain32), exact)
                prefill = logits[:, :XLSTM_DECODE_FULL].clone()
                what = (f"kernels vs plain {rec['vs_plain']}, the plain "
                        f"path's one-ulp spread {rec['one_ulp_spread']}")
            else:
                rec["vs_f32"] = _spread(logits.float(), exact)
                del exact
                what = f"vs the f32 forward {rec['vs_f32']}"
            del logits
            out[name] = rec
            log("xlstm + vision", f"(a) {XLSTM_ARCH} full width and depth "
                                  f"({n_params} params), prefill [{XLSTM_B}, "
                                  f"{XLSTM_S}] {name}: kernels {wall!r} s = "
                                  f"{n_tok / wall!r} tokens/s"
                                  + (f", plain versions "
                                     f"{rec['plain_wall_s']!r} s"
                                     if name == "f32" else "")
                                  + f", peak memory {peak} B; max |logit| "
                                  f"{rec['logits_scale']!r}; logits {what} "
                                  f"(chaotic at this depth: no limit); "
                                  f"launches {counts}")

        # the wall split by mixer kind, each layer timed between syncs
        spent, n_calls = {}, {}
        forwards = dict(model_mod._FORWARD)

        def timed(kind):
            fn = forwards[kind]

            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = fn(*a, **kw)
                torch.cuda.synchronize()
                spent[kind] = spent.get(kind, 0.0) + time.perf_counter() - t0
                n_calls[kind] = n_calls.get(kind, 0) + 1
                return y
            return wrapper

        model_mod._FORWARD.update({k: timed(k) for k in ("mlstm", "slstm")})
        try:
            split_wall, _ = run(p32, cfg, call32)
        finally:
            model_mod._FORWARD.update(forwards)
        # device events of one layer of each kind (torch.profiler); the
        # sLSTM's over its first XLSTM_PROFILE_STEPS steps, a step's
        # events being the same at every step
        x = torch.randn((XLSTM_B, XLSTM_S, cfg.d_model), generator=gen,
                        device="cuda")
        per_layer = {}
        for kind, i, s in (("mlstm", 0, XLSTM_S),
                           ("slstm", cfg.ssm.slstm_every - 1,
                            XLSTM_PROFILE_STEPS)):
            launches, dev_ms, _ = _profile_window(
                lambda: forwards[kind](p32.layers[i].mixer, x[:, :s],
                                       cfg=cfg), 1)
            per_layer[kind] = {"steps": s, "launches": launches,
                               "device_ms": dev_ms}
        del x
        out["split"] = {"wall_s": split_wall, "mixer_s": spent,
                        "layers": n_calls, "per_layer": per_layer}
        log("xlstm + vision", f"(a) the f32 prefill timed layer by layer: "
                              f"{split_wall!r} s in all, mLSTM layers "
                              f"{spent['mlstm']!r} s ({n_calls['mlstm']} "
                              f"layers), sLSTM layers {spent['slstm']!r} s "
                              f"({n_calls['slstm']}); sLSTM / mLSTM "
                              f"{spent['slstm'] / spent['mlstm']!r}; one "
                              f"layer profiled: {per_layer}")

        # decode steps at full depth (f32, kernels on)
        cache = init_cache(cfg, XLSTM_B, XLSTM_DECODE_FULL, torch.float32)
        torch.cuda.synchronize()
        _reset_counts()
        errs = []
        t0 = time.perf_counter()
        for t in range(XLSTM_DECODE_FULL):
            lg, cache = forward_decode(p32, cfg, call32,
                                       {"tokens": tokens[:, t]}, cache, t)
            errs.append((lg - prefill[:, t]).abs().max())
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
        dcounts = _counts()
        if dcounts["rmsnorm"] != want_rms * XLSTM_DECODE_FULL:
            raise AssertionError(f"xlstm decode launches {dcounts}")
        out["decode"] = {"steps": XLSTM_DECODE_FULL,
                         "ms_per_step": dwall / XLSTM_DECODE_FULL * 1e3,
                         "vs_prefill_max": torch.stack(errs).max().item(),
                         "launches": dcounts}
        log("xlstm + vision", f"(a) {XLSTM_DECODE_FULL} decode steps at "
                              f"full depth, B={XLSTM_B}, f32: "
                              f"{out['decode']['ms_per_step']!r} ms/step; "
                              f"logits vs the prefill's max abs "
                              f"{out['decode']['vs_prefill_max']!r} "
                              f"(chaotic at this depth: no limit); "
                              f"launches {dcounts}")
        emb = p32.embed.detach()[tokens[:, :DECODE_STEPS]].clone()
        mixers = {k: copy.deepcopy(p32.layers[i].mixer) for k, i in
                  (("mlstm", 0), ("slstm", cfg.ssm.slstm_every - 1))}
        norm_w = p32.layers[0].norm1.detach().clone()
        del p16, p32, cache, prefill
        torch.cuda.empty_cache()

        # (b) depth XLSTM_ACC_DEPTH at full width
        cfg8 = dataclasses.replace(cfg, n_layers=XLSTM_ACC_DEPTH)
        q16 = init_params(cfg8, 1, dtype=bf16)
        q32 = copy.deepcopy(q16).float()
        _, k32 = run(q32, cfg8, call32)
        _, exact = run(q32, cfg8, plain32)
        nudged = nudged_run(q32, cfg8, plain32)
        spread = _spread(nudged, exact)
        spread_first = (nudged - exact)[:, :DECODE_STEPS].abs().max().item()
        del nudged
        vs_plain = _spread(k32, exact)
        lim = max(LOGITS_TOL, FLOOR_FACTOR * spread["max"])
        cache = init_cache(cfg8, XLSTM_B, DECODE_STEPS, torch.float32)
        errs = []
        for t in range(DECODE_STEPS):
            lg, cache = forward_decode(q32, cfg8, call32,
                                       {"tokens": tokens[:, t]}, cache, t)
            errs.append((lg - k32[:, t]).abs().max())
        worst = torch.stack(errs).max().item()
        dlim = max(DECODE_TOL, FLOOR_FACTOR * spread_first)
        del k32, cache
        _, k16 = run(q16, cfg8, call16)
        _, p16l = run(q16, cfg8, plain16)
        errs16 = _bf16_errors(k16, p16l, exact)
        del q16, q32, exact, k16, p16l
        torch.cuda.empty_cache()
    out["depth8"] = {"vs_plain": vs_plain, "one_ulp_spread": spread,
                     "limit": lim, "decode_vs_prefill": worst,
                     "one_ulp_spread_first_256": spread_first,
                     "decode_limit": dlim, "bf16_vs_f32": errs16}
    log("xlstm + vision", f"(b) depth {XLSTM_ACC_DEPTH} (seven mLSTM, one "
                          f"sLSTM) at full width, f32: logits kernels vs "
                          f"plain {vs_plain} (limit {lim!r}: {LOGITS_TOL} "
                          f"or {FLOOR_FACTOR}x the plain path's one-ulp "
                          f"spread {spread}); {DECODE_STEPS} decode steps vs "
                          f"the prefill max abs {worst!r} (limit {dlim!r}: "
                          f"{DECODE_TOL} or {FLOOR_FACTOR}x the spread over "
                          f"those positions, {spread_first!r}); bf16 vs the "
                          f"f32 forward {errs16} (ratio at most "
                          f"{LOGITS_BF16_RATIO})")
    if not vs_plain["max"] <= lim:
        raise AssertionError(f"xlstm depth {XLSTM_ACC_DEPTH} logits, kernels "
                             f"vs plain {vs_plain} > {lim}")
    if not worst <= dlim:
        raise AssertionError(f"xlstm depth {XLSTM_ACC_DEPTH} decode off the "
                             f"prefill: {worst} > {dlim}")

    # (c) each mixer at full width on the model's normed embeddings: its
    # recurrent form step by step against its forward (the mLSTM's
    # chunked form), the reference's own bound
    h = rms_norm(emb, norm_w, cfg.norm_eps)
    out["mixers"] = {}
    with torch.no_grad():
        for kind, w in mixers.items():
            fwd = getattr(ssm, f"{kind}_forward")(w, h, cfg=cfg)
            state = getattr(ssm, f"{kind}_init_state")(cfg, XLSTM_B,
                                                       torch.float32, "cuda")
            steps = []
            for t in range(DECODE_STEPS):
                y, state = getattr(ssm, f"{kind}_decode")(
                    w, h[:, t:t + 1], state, cfg=cfg)
                steps.append(y)
            err = (torch.cat(steps, dim=1) - fwd).abs().max().item()
            out["mixers"][kind] = {"decode_vs_forward": err,
                                   "scale": fwd.abs().max().item()}
            log("xlstm + vision", f"(c) {kind} at full width, {DECODE_STEPS} "
                                  f"decode steps vs its forward: max abs "
                                  f"{err!r} (max |y| "
                                  f"{out['mixers'][kind]['scale']!r}; tol "
                                  f"{DECODE_TOL})")
            if not err <= DECODE_TOL:
                raise AssertionError(f"xlstm {kind} decode vs forward {err}")
    del mixers, emb, h
    torch.cuda.empty_cache()

    cases = [rms_case(n, d, dt, wdt) for n, d, dt, wdt in XV_RMS_CASES[:2]]
    for c in cases:
        log_case("xlstm + vision", "(a) rmsnorm at xlstm's prefill shape", c)
    out["rmsnorm"] = cases
    results["xlstm"] = out


def phase_vision(results: dict) -> None:
    """llama-3.2-vision-11b at full width and depth, bf16: the [2, 2048]
    prefill with the flash and RMSNorm kernels, each held against its
    plain version at these shapes; a 32-token greedy_generate; and, at
    depth VISION_ACC_DEPTH, the bf16 logits against a float32 forward."""
    import copy
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import (CallConfig, forward_train, init_cache,
                                    init_params, param_count_actual)

    cfg = get_config(VISION_ARCH)
    bf16 = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dtype=bf16)
    n_params = param_count_actual(params)
    if n_params != VISION_PARAMS:
        raise AssertionError(f"llama-3.2-vision-11b has {n_params} params")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (VISION_B, VISION_S), generator=gen,
                           device="cuda")
    mem = (0.02 * torch.randn((VISION_B, cfg.cross_attn.n_mem_tokens,
                               cfg.d_model), generator=gen,
                              device="cuda")).to(bf16)
    batch = {"tokens": tokens, "vision_mem": mem}
    call = CallConfig(compute_dtype=bf16, attention_impl="pallas",
                      use_pallas_norm=True, remat=False)
    plain = dataclasses.replace(call, kernel_backend="ref")
    n_cross = sum(cfg.layer_has_cross_attn(i) for i in range(cfg.n_layers))
    want_rms = 2 * cfg.n_layers + n_cross + 1
    n_tok = VISION_B * VISION_S
    out = {"params": n_params}

    def run(params, cfg, call, b=batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = forward_train(params, cfg, call, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    with torch.no_grad():
        warm = {"tokens": tokens[:, :128], "vision_mem": mem}
        forward_train(params, cfg, call, warm)            # first calls
        forward_train(params, cfg, plain, warm)
        _reset_counts()
        wall, logits = run(params, cfg, call)
        counts = _counts()
        routes = dict(fk.route_counts)
        wall_plain, logits_plain = run(params, cfg, plain)
        launches, dev_ms, top = _profile_window(
            lambda: forward_train(params, cfg, call, batch), 1)
    diff = (logits - logits_plain).abs().max().item()
    scale = logits_plain.abs().max().item()
    ok = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits, logits_plain
    log("xlstm + vision", f"(b) {VISION_ARCH} full width and depth "
                          f"({n_params} params, bf16), prefill [{VISION_B}, "
                          f"{VISION_S}] with vision_mem [{VISION_B}, "
                          f"{cfg.cross_attn.n_mem_tokens}, {cfg.d_model}]: "
                          f"kernels {wall!r} s = {n_tok / wall!r} tokens/s; "
                          f"plain versions {wall_plain!r} s; logits kernels "
                          f"vs plain max abs {diff!r} (max |logit| "
                          f"{scale!r}); launches {counts}, flash by kernel "
                          f"{routes}; one forward profiled: {launches!r} "
                          f"device events, device busy {dev_ms!r} ms")
    for e in top:
        log("xlstm + vision", f"  {e.self_device_time_total / 1e3!r} ms "
                              f"x{e.count}  {e.key[:90]}")
    if not ok or shape != (VISION_B, VISION_S, cfg.vocab):
        raise AssertionError(f"vision prefill logits {shape}, finite {ok}")
    if counts["flash_attention"] != cfg.n_layers or routes["tc"] != \
            cfg.n_layers or counts["rmsnorm"] != want_rms:
        raise AssertionError(f"expected {cfg.n_layers} flash (tensor-core) "
                             f"and {want_rms} rmsnorm launches, got "
                             f"{counts} {routes}")
    out["prefill"] = {"wall_s": wall, "tokens_per_s": n_tok / wall,
                      "plain_wall_s": wall_plain, "logits_diff": diff,
                      "logits_scale": scale, "launches": counts,
                      "flash_routes": routes, "profile_events": launches,
                      "device_ms": dev_ms}

    # serving: the prompt token by token, then greedy decoding
    cache = init_cache(cfg, VISION_B, VISION_PROMPT + VISION_GEN, bf16)
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        toks, _ = greedy_generate(params, cfg, call,
                                  {"tokens": tokens[:, :VISION_PROMPT],
                                   "vision_mem": mem}, cache,
                                  VISION_PROMPT, VISION_GEN)
        toks = toks.cpu()
        gen_wall = time.perf_counter() - t0
        gen_counts = _counts()
    n_steps = VISION_PROMPT + VISION_GEN - 1
    peak = torch.cuda.max_memory_allocated()
    log("xlstm + vision", f"(b) greedy_generate B={VISION_B} prompt "
                          f"{VISION_PROMPT} gen {VISION_GEN}: {gen_wall!r} "
                          f"s, {gen_wall / n_steps * 1e3!r} ms per decode "
                          f"step ({n_steps} steps), tokens "
                          f"{tuple(toks.shape)}, first {toks[0, :8].tolist()};"
                          f" launches {gen_counts} "
                          f"({gen_counts['rmsnorm'] / n_steps!r} rmsnorm a "
                          f"step); peak memory {peak} B")
    if tuple(toks.shape) != (VISION_B, VISION_GEN) or \
            not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"vision greedy_generate returned {toks.shape}")
    if gen_counts["rmsnorm"] != want_rms * n_steps or \
            gen_counts["flash_attention"]:
        raise AssertionError(f"vision decode launches {gen_counts}")
    out["decode"] = {"wall_s": gen_wall, "steps": n_steps,
                     "ms_per_step": gen_wall / n_steps * 1e3,
                     "launches": gen_counts,
                     "launches_per_step": {k: v / n_steps for k, v in
                                           gen_counts.items()
                                           if isinstance(v, int)}}
    out["peak_bytes"] = peak
    del params, cache
    torch.cuda.empty_cache()

    # the kernels at the prefill's shapes against their plain versions
    out["flash"] = flash_case(*XV_FLASH_CASE)
    out["rmsnorm"] = rms_case(*XV_RMS_CASES[2])
    log_case("xlstm + vision", "(b) flash at the vision prefill's shape",
             out["flash"])
    log_case("xlstm + vision", "(b) rmsnorm at the vision prefill's shape",
             out["rmsnorm"])

    # accuracy at depth 5, full width: bf16 kernels and plain path each
    # against a float32 forward of the same weights
    cfg5 = dataclasses.replace(cfg, n_layers=VISION_ACC_DEPTH)
    p16 = init_params(cfg5, 1, dtype=bf16)
    p32 = copy.deepcopy(p16).float()
    with torch.no_grad():
        _, exact = run(p32, cfg5, dataclasses.replace(
            plain, compute_dtype=torch.float32))
        del p32
        _, k16 = run(p16, cfg5, call)
        _, q16 = run(p16, cfg5, plain)
    errs = _bf16_errors(k16, q16, exact)
    out["depth5"] = {"logits_err_vs_f32": errs,
                     "logits_scale": exact.abs().max().item()}
    log("xlstm + vision", f"(b) depth {VISION_ACC_DEPTH} at full width "
                          f"(one super-block with its cross layer), bf16 "
                          f"logits vs a float32 forward of the same weights "
                          f"(max |logit| {out['depth5']['logits_scale']!r}): "
                          f"kernels {errs['kernels']}, plain {errs['plain']}"
                          f" (ratio at most {LOGITS_BF16_RATIO})")
    del p16, exact, k16, q16
    torch.cuda.empty_cache()
    results["vision"] = out


# ---------------------------------------------------------------------------
# slice 14: the mesh (phase 20): DTensor placements on a 1x1 mesh, the dry
# run's cost model against the card, production cells dry-run
# ---------------------------------------------------------------------------

MESH_STEPS, MESH_B, MESH_S = 5, 8, 512        # phase 20 (a), smollm-135m
MESH_REL = 1e-6                               # (a) sharded vs unsharded
MESH_CELLS = (("smollm-135m", "train_4k"), ("qwen3-14b", "decode_32k"),
              ("dbrx-132b", "train_4k"),
              ("jamba-1.5-large-398b", "prefill_32k"))
DRYRUN_WAIT_S = 600        # (d): the longest phase 20 waits for the cells
_DRYRUN_CELLS = """
import json, os, sys
os.nice(19)          # the phases' host work comes first
from repro_torch.launch import dryrun
for arch, shape in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, False, device="cuda", verbose=False)
    print(json.dumps(rec, default=str), flush=True)
"""


def start_dryrun_cells():
    """Phase 20 (d)'s dry runs of MESH_CELLS in a process of their own,
    started with the script: host work on placeholder tensors, so it runs
    beside the other phases, at the lowest scheduling priority. Returns (the process, the file its records
    go to, one JSON line a cell; the process's stderr beside it)."""
    out = ROOT / "build" / "dryrun_cells.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    with open(out, "w") as f, open(f"{out}.log", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DRYRUN_CELLS, json.dumps(MESH_CELLS)],
            stdout=f, stderr=err, env=env, cwd=ROOT)
    return proc, out


def _first_diff(a: dict, b: dict):
    """The first name whose tensors differ (bit for bit), or None."""
    import torch
    return next((n for n in a if not torch.equal(a[n], b[n])), None)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_train(cfg, mesh, steps: int, b: int, s: int) -> dict:
    """``steps`` make_train_step steps of ``cfg`` twice from one seed-0
    parameter set and the same batches: placed on ``mesh`` by
    param_shardings, _opt_shardings and batch_shardings (parameters,
    moments and the first batch placed from the CPU, the allocator's
    requested bytes read around it), and unsharded on the card. Returns
    losses, walls, the params' largest relative difference, the first
    leaf that differs bit for bit, the placement's bytes and the last
    unsharded step's FLOPs (FlopCounterMode)."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.launch.dryrun import _opt_shardings
    from repro_torch.models import CallConfig, init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    shape = ShapeConfig("t", "train", s, b)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20)
    step = make_train_step(cfg, CallConfig(compute_dtype=torch.float32,
                                           attention_impl="dense",
                                           remat=False), opt)
    cpu = init_params(cfg, 0, device="cpu")
    batches = [global_batch(cfg, shape, DataConfig(), i, device="cpu")
               for i in range(steps + 1)]
    plain = copy.deepcopy(cpu).cuda()
    st_plain = init_opt_state(opt, plain)

    def requested():
        torch.cuda.synchronize()
        return (torch.cuda.memory_stats()["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    r0 = requested()
    p_sh = sh.param_shardings(cfg, mesh, cpu)
    state = init_opt_state(opt, cpu)
    sharded = sh.place_params(copy.deepcopy(cpu), p_sh)
    st_sh = sh.place_tree(state, _opt_shardings(mesh, state, p_sh))
    b_sh = sh.batch_shardings(cfg, shape, mesh, batches[0])
    first = sh.place_tree(batches[0], b_sh)
    r1 = requested()
    sync = torch.cuda.synchronize
    out = {"loss_plain": [], "loss_mesh": [], "wall_plain": [],
           "wall_mesh": [], "requested_bytes": r1[0] - r0[0],
           "allocated_bytes": r1[1] - r0[1]}
    for i in range(steps):
        bp = {k: v.cuda() for k, v in batches[i].items()}
        bm = first if i == 0 else sh.place_tree(batches[i], b_sh)
        sync()
        t0 = time.perf_counter()
        plain, st_plain, mp = step(plain, st_plain, bp)
        sync()
        t1 = time.perf_counter()
        if i == 0:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        sharded, st_sh, mm = step(sharded, st_sh, bm)
        sync()
        t2 = time.perf_counter()
        if i == 0:
            out["step_peak_growth"] = torch.cuda.max_memory_allocated() \
                - base
        out["wall_plain"].append(t1 - t0)
        out["wall_mesh"].append(t2 - t1)
        out["loss_plain"].append(mp["loss"].item())
        out["loss_mesh"].append(_full(mm["loss"]).item())
    pa = {n: q.detach() for n, q in plain.named_parameters()}
    pm = {n: _full(q.detach()) for n, q in sharded.named_parameters()}
    out["param_rel"] = max(
        ((pa[n] - pm[n]).abs().max() / pa[n].abs().max().clamp(
            min=1e-30)).item() for n in pa)
    out["loss_rel"] = max(abs(a - b) / abs(a) for a, b in
                          zip(out["loss_plain"], out["loss_mesh"]))
    out["first_diff"] = _first_diff(pa, pm)
    out["bitwise"] = out["first_diff"] is None and \
        out["loss_plain"] == out["loss_mesh"]
    bp = {k: v.cuda() for k, v in batches[steps].items()}
    with FlopCounterMode(display=False) as fc:
        step(plain, st_plain, bp)
    out["flops"] = fc.get_total_flops()
    out["mesh_placements"] = {n: str(q.placements) for n, q in
                              list(sharded.named_parameters())[:3]}
    return out


def mesh_prefill(cfg, params, tokens, call, mesh) -> dict:
    """The prefill through ``mesh`` (parameters and tokens placed by the
    rules) against the unsharded forward on the same weights: logits of
    each, the mesh run's wall and the kernels' launches in it."""
    import copy

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import forward_train

    shape = ShapeConfig("p", "prefill", tokens.shape[1], tokens.shape[0])
    sharded = sh.place_params(copy.deepcopy(params),
                              sh.param_shardings(cfg, mesh, params))
    batch = sh.place_tree({"tokens": tokens}, sh.batch_shardings(
        cfg, shape, mesh, {"tokens": tokens}))
    with torch.no_grad():
        want, _ = forward_train(params, cfg, call, {"tokens": tokens})
        forward_train(sharded, cfg, call, batch)          # first calls
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        got, _ = forward_train(sharded, cfg, call, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
    return {"logits": _full(got), "want": want, "wall_s": wall,
            "launches": counts}


def phase_mesh(results: dict) -> None:
    """(a) smollm-135m full-width training on a 1x1 mesh against the same
    steps unsharded; (b) the bf16 kernel prefill through the mesh; (c) the
    dry run's cost model against the card; (d) four production cells
    dry-run on the 16x16 mesh."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import CallConfig

    cfg = get_config("smollm-135m")
    mesh = make_debug_mesh(1, 1)          # NCCL, one rank, in-process store
    res: dict = {"mesh": f"{mesh}"}
    # (a)
    tr = mesh_train(cfg, mesh, MESH_STEPS, MESH_B, MESH_S)
    log("mesh", f"(a) {cfg.name} full width, {MESH_STEPS} steps of "
                f"[{MESH_B}, {MESH_S}] f32 dense on the 1x1 mesh vs "
                f"unsharded: losses {tr['loss_mesh']!r} vs "
                f"{tr['loss_plain']!r}; loss rel {tr['loss_rel']!r}, "
                f"params rel {tr['param_rel']!r} (limit {MESH_REL}); "
                f"bitwise {tr['bitwise']} (first leaf that differs: "
                f"{tr['first_diff']}); step walls mesh {tr['wall_mesh']!r} "
                f"s, unsharded {tr['wall_plain']!r} s; placements "
                f"{tr['mesh_placements']}")
    res["train"] = {k: v for k, v in tr.items() if k != "mesh_placements"}
    if not (tr["loss_rel"] <= MESH_REL and tr["param_rel"] <= MESH_REL):
        raise AssertionError(f"mesh train vs unsharded: loss rel "
                             f"{tr['loss_rel']}, params {tr['param_rel']}")
    # (b)
    _, params, tokens, call = _smollm("bfloat16")
    pf = mesh_prefill(cfg, params, tokens, call, mesh)
    same = bool(torch.equal(pf["logits"], pf["want"]))
    diff = (pf["logits"].float() - pf["want"].float()).abs().max().item()
    w14 = results.get("prefill_bf16", {}).get("wall_s")
    log("mesh", f"(b) bf16 prefill [{PREFILL_B}, {PREFILL_S}] with the "
                f"kernels through the mesh (local_map): {pf['wall_s']!r} s "
                f"(phase 14 unsharded median {w14!r} s); logits bitwise "
                f"equal to the unsharded kernels' {same} (max abs {diff!r});"
                f" launches {pf['launches']}")
    res["prefill"] = {"wall_s": pf["wall_s"], "phase14_wall_s": w14,
                      "bitwise": same, "max_abs": diff,
                      "launches": pf["launches"]}
    want_rms = 2 * cfg.n_layers + 1
    if pf["launches"]["flash_attention"] != cfg.n_layers \
            or pf["launches"]["rmsnorm"] != want_rms:
        raise AssertionError(f"mesh prefill: expected {cfg.n_layers} flash "
                             f"and {want_rms} rmsnorm launches, got "
                             f"{pf['launches']}")
    if not same:
        raise AssertionError(f"mesh prefill logits differ from the "
                             f"unsharded kernels' by {diff}")
    del params, tokens, pf
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    # (c) the dry run of cell (a) on a fake 1x1 mesh against the card
    rec = dryrun.run_cell(cfg.name, "t", call=CallConfig(
        compute_dtype=torch.float32, attention_impl="dense", remat=False),
        device="cuda", mesh_shape=(1, 1),
        shape=ShapeConfig("t", "train", MESH_S, MESH_B), verbose=False)
    mem = rec["memory"]
    steady = statistics.median(tr["wall_plain"][1:])
    log("mesh", f"(c) dry run of (a) on a 1x1 mesh: argument bytes "
                f"{mem['argument_bytes']} vs the allocator's requested "
                f"bytes {tr['requested_bytes']} from placing params, "
                f"moments and batch (memory_allocated grew "
                f"{tr['allocated_bytes']}, 512-B blocks "
                f"{mem['argument_alloc_bytes']}); FLOPs "
                f"{rec['flops_per_device']!r} vs FlopCounterMode "
                f"{tr['flops']!r} on the card; compute term "
                f"{rec['compute_s']!r} s, memory term {rec['memory_s']!r} s "
                f"(f32 67e12 FLOP/s, 3.35e12 B/s; {rec['bytes_per_device']!r}"
                f" B), dominant {rec['dominant']}; measured step wall "
                f"{steady!r} s (median of steps 2-{MESH_STEPS}, unsharded); "
                f"peak of live bytes {mem['peak_bytes']} B, "
                f"{mem['peak_bytes'] - mem['argument_bytes']} B over the "
                f"arguments, vs max_memory_allocated's growth over the "
                f"first sharded step {tr.get('step_peak_growth')} B; dry "
                f"run {rec['seconds']!r} s")
    res["cost"] = {"argument_bytes": mem["argument_bytes"],
                   "requested_bytes": tr["requested_bytes"],
                   "allocated_bytes": tr["allocated_bytes"],
                   "argument_alloc_bytes": mem["argument_alloc_bytes"],
                   "flops": rec["flops_per_device"],
                   "flops_card": tr["flops"],
                   "compute_s": rec["compute_s"],
                   "memory_s": rec["memory_s"], "step_wall_s": steady,
                   "peak_bytes": mem["peak_bytes"],
                   "step_peak_growth": tr.get("step_peak_growth")}
    if mem["argument_bytes"] != tr["requested_bytes"]:
        raise AssertionError(f"dry-run argument bytes "
                             f"{mem['argument_bytes']} != the card's "
                             f"{tr['requested_bytes']}")
    if rec["flops_per_device"] != tr["flops"]:
        raise AssertionError(f"dry-run FLOPs {rec['flops_per_device']} != "
                             f"FlopCounterMode's {tr['flops']}")
    # (d) production cells on the 16x16 mesh (256 fake ranks), dry-run by
    # the process start_dryrun_cells started with the script
    proc, path = results["dryrun_cells"]
    t0 = time.perf_counter()
    rc = proc.wait(timeout=DRYRUN_WAIT_S)
    log("mesh", f"(d) the dry-run process ended with {rc} "
                f"({time.perf_counter() - t0!r} s waited for it here)")
    recs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith("{")]
    if rc != 0 or len(recs) != len(MESH_CELLS):
        raise AssertionError(f"dry run of {MESH_CELLS}: exit {rc}, "
                             f"{len(recs)} records; see {path}.log")
    cells = {}
    for (arch, shape), rec in zip(MESH_CELLS, recs):
        cells[f"{arch}/{shape}"] = {
            k: rec[k] for k in ("seconds", "flops_per_device",
                                "bytes_per_device",
                                "collective_bytes_per_device", "compute_s",
                                "memory_s", "collective_s", "dominant",
                                "useful_flop_ratio", "fits_h100_80gb")}
        cells[f"{arch}/{shape}"]["memory"] = rec["memory"]
        log("mesh", f"(d) {arch} x {shape} x 16x16: {rec['seconds']!r} s; "
                    f"a device: arguments {rec['memory']['argument_bytes']} "
                    f"B, outputs {rec['memory']['output_bytes']} B, peak "
                    f"{rec['memory']['peak_bytes']} B; compute "
                    f"{rec['compute_s']!r} s, memory {rec['memory_s']!r} s, "
                    f"collective {rec['collective_s']!r} s "
                    f"({rec['collectives']}); dominant {rec['dominant']}; "
                    f"useful FLOP ratio {rec['useful_flop_ratio']!r}; fits "
                    f"one H100 80 GB: {rec['fits_h100_80gb']}")
    res["cells"] = cells
    results["mesh"] = res


# ---------------------------------------------------------------------------
# slice 16: the examples through the port and the audio family (phase 21)
# ---------------------------------------------------------------------------

MUSICGEN_ARCH, MUSICGEN_PARAMS = "musicgen-medium", 1_815_234_048
MUSICGEN_B, MUSICGEN_S = 4, 2048             # the prefill's frames
MUSICGEN_DECODE = 64                         # decode positions vs prefill
# the wan demo's Fig-6 ordering: each protocol's saturation throughput at
# least this many times the next one's (mandator-sporades > multipaxos >
# epaxos > rabia)
FIG6_FACTOR = 2.0
# a leader crash's dip: some bucket from the crash on below this share of
# the last bucket before it
CRASH_DIP = 0.5


def _example(name: str):
    """examples/<name>.py as a module, imported by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(tag: str, fn, *args, **kw):
    """(its result, wall s, its printed lines): ``fn`` run with its
    standard output caught; each line is logged after it returns."""
    import contextlib
    import io

    import torch
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log("examples", f"{tag} | {line}")
    log("examples", f"{tag}: {wall!r} s")
    return out, wall, lines


def examples_on_card() -> dict:
    """(a) Each examples/torch_*.py on the card at the reference script's
    own sizes, and the checks the reference scripts make."""
    import json
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.obs import export

    wan = _example("torch_wan_consensus_demo")
    out = {}
    _reset_counts()
    tour, out["paper_tour_s"], _ = _run_example("wan paper tour",
                                                wan.main, [])
    thr = {p: float(r["throughput"]) for p, r in tour["tour"].items()}
    order = ("mandator-sporades", "multipaxos", "epaxos", "rabia")
    for hi, lo in zip(order, order[1:]):
        if not thr[hi] >= FIG6_FACTOR * thr[lo]:
            raise AssertionError(f"Fig-6 ordering: {hi} {thr[hi]} tx/s not "
                                 f">= {FIG6_FACTOR} x {lo} {thr[lo]}")
    crash_bucket = int(1.5 / 0.5)                # the crash at 1.5 s
    dips = {}
    for p, r in tour["crash"].items():
        tl = np.asarray(r["timeline"], np.float64)
        dips[p] = float(tl[crash_bucket:].min() / tl[crash_bucket - 1])
        if not dips[p] < CRASH_DIP:
            raise AssertionError(f"{p}: no dip after the leader crash: "
                                 f"timeline {tl.tolist()}")
    out["tour_throughput"] = thr
    out["crash_dip"] = dips
    out["tour_medians_ms"] = {p: float(r["median_ms"])
                              for p, r in tour["tour"].items()}

    rows, out["region_outage_s"], _ = _run_example(
        "wan --scenario region-outage", wan.main,
        ["--scenario", "region-outage"])
    rows2, out["closed_loop_ddos_s"], _ = _run_example(
        "wan --workload closed-loop --scenario paper-ddos", wan.main,
        ["--workload", "closed-loop", "--scenario", "paper-ddos"])
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "ddos.json")
        rows3, out["trace_s"], _ = _run_example(
            "wan --trace --scenario paper-ddos --rate 300000", wan.main,
            ["--trace", path, "--scenario", "paper-ddos", "--rate",
             "300000"])
        trace = json.loads(Path(path).read_text())
    export.validate(trace)
    out["trace_events"] = len(trace["traceEvents"])
    for what, rs in (("region-outage", rows), ("closed-loop", rows2),
                     ("trace", {k: v for k, v in rows3.items()
                                if k != "trace"})):
        for p, r in rs.items():
            if not (r["committed"] > 0 and math.isfinite(r["throughput"])):
                raise AssertionError(f"{what} {p}: committed "
                                     f"{r['committed']}, throughput "
                                     f"{r['throughput']}")
    if any(r.get("inflight_max") is None for r in rows2.values()):
        raise AssertionError("closed-loop rows without inflight_max")
    out["throughput"] = {
        "region-outage": {p: float(r["throughput"]) for p, r in rows.items()},
        "closed-loop-ddos": {p: float(r["throughput"])
                             for p, r in rows2.items()}}
    counts = _counts()
    out["launches"] = {k: v for k, v in counts.items() if k != "_programs"}
    out["programs"] = counts["_programs"]
    log("examples", f"wan demo: Fig-6 throughput {thr}, dips after the "
                    f"crash (least bucket / the bucket before) {dips}, "
                    f"trace {out['trace_events']} events valid; launches "
                    f"{out['launches']}, tick programs {out['programs']}")
    if not counts["channel_ring_commit_graph"] > 0:
        raise AssertionError(f"the wan demo ran no commit kernel: {counts}")

    _reset_counts()
    qs, out["quickstart_s"], _ = _run_example(
        "quickstart", _example("torch_quickstart").main, [])
    vocab = get_config("smollm-135m").reduced().vocab
    toks = qs["serve"]["tokens"]
    if qs["first"]["commits"] != [60] or qs["resumed"]["commits"] != [20] \
            or len(qs["resumed"]["losses"]) != 20:
        raise AssertionError(f"quickstart commits {qs['first']['commits']}, "
                             f"{qs['resumed']['commits']}")
    if toks.shape != (2, 16) or not ((toks >= 0) & (toks < vocab)).all():
        raise AssertionError(f"quickstart decoded {toks.shape}")
    out["quickstart_loss"] = (qs["first"]["losses"][0],
                              qs["first"]["losses"][-1])
    cl, out["train_smr_cluster_s"], _ = _run_example(
        "train_smr_cluster", _example("torch_train_smr_cluster").main, [])
    if cl["train"]["commits"] != [30, 30, 10] or \
            any(r is None for r in cl["records"]):
        raise AssertionError(f"train_smr_cluster commits "
                             f"{cl['train']['commits']}, records "
                             f"{cl['records']}")
    sb, out["serve_batch_s"], _ = _run_example(
        "serve_batch", _example("torch_serve_batch").main, [])
    for arch, res in sb.items():
        v = get_config(arch).reduced().vocab
        t = res["tokens"]
        if t.shape != (2, 12) or not ((t >= 0) & (t < v)).all():
            raise AssertionError(f"serve_batch {arch}: {t.shape}")
    out["serve_batch_tokens_s"] = {a: r["seconds"] for a, r in sb.items()}
    counts = {k: v for k, v in _counts().items() if k != "_programs"}
    log("examples", f"model examples: quickstart loss "
                    f"{out['quickstart_loss']}, every step committed; "
                    f"cluster commits {cl['train']['commits']}; launches "
                    f"{counts}")
    return out


def musicgen_on_card() -> dict:
    """(b) musicgen-medium at full width and depth, random weights from
    seed 0: the f32 [4, 2048] frame prefill with the kernels against the
    plain path, decode against the prefill over MUSICGEN_DECODE positions,
    the bf16 prefill by the 1.5x rule, serve() at full width."""
    import copy
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve
    from repro_torch.models import (CallConfig, forward_decode,
                                    forward_train, init_cache, init_params,
                                    param_count_actual)

    cfg = get_config(MUSICGEN_ARCH)
    f32, bf16 = torch.float32, torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    frames = 0.02 * torch.randn((MUSICGEN_B, MUSICGEN_S, cfg.d_model),
                                generator=gen, device="cuda")
    n_tok = MUSICGEN_B * MUSICGEN_S
    want_rms = 2 * cfg.n_layers + 1

    def run(params, call, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = forward_train(params, cfg, call, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    def check_launches(what, counts, routes, route):
        if counts["flash_attention"] != cfg.n_layers or \
                routes[route] != cfg.n_layers or \
                counts["rmsnorm"] != want_rms:
            raise AssertionError(f"musicgen {what}: expected "
                                 f"{cfg.n_layers} flash ({route}) and "
                                 f"{want_rms} rmsnorm launches, got "
                                 f"{counts} {routes}")

    # float32: kernels against the plain path, then decode vs prefill
    params = init_params(cfg, 0, dtype=f32)
    n_params = param_count_actual(params)
    if n_params != MUSICGEN_PARAMS:
        raise AssertionError(f"{MUSICGEN_ARCH} has {n_params} params")
    call = CallConfig(compute_dtype=f32, attention_impl="pallas",
                      use_pallas_norm=True, remat=False)
    plain = dataclasses.replace(call, kernel_backend="ref")
    batch = {"frame_emb": frames}
    with torch.no_grad():
        warm = {"frame_emb": frames[:, :128]}
        forward_train(params, cfg, call, warm)             # first calls
        forward_train(params, cfg, plain, warm)
        _reset_counts()
        wall, logits = run(params, call, batch)
        counts = _counts()
        routes = dict(fk.route_counts)
        wall_plain, logits_plain = run(params, plain, batch)
    diff = (logits - logits_plain).abs().max().item()
    ok = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    ref = logits[:, :MUSICGEN_DECODE].clone()
    del logits, logits_plain
    log("examples", f"(b) {MUSICGEN_ARCH} full width and depth ({n_params} "
                    f"params, {cfg.n_layers} layers, H = Kh = "
                    f"{cfg.n_heads}, D {cfg.head_dim}), frame_emb "
                    f"[{MUSICGEN_B}, {MUSICGEN_S}, {cfg.d_model}] float32: "
                    f"kernels {wall!r} s = {n_tok / wall!r} frames/s; plain "
                    f"{wall_plain!r} s; logits max abs diff {diff!r} (tol "
                    f"{LOGITS_TOL}); launches {counts}, flash by kernel "
                    f"{routes}")
    if not ok or shape != (MUSICGEN_B, MUSICGEN_S, cfg.vocab):
        raise AssertionError(f"musicgen prefill logits {shape}, finite {ok}")
    if not diff <= LOGITS_TOL:
        raise AssertionError(f"musicgen prefill, kernels vs plain: {diff}")
    check_launches("f32 prefill", counts, routes, "tf32")
    out["prefill_f32"] = {"wall_s": wall, "frames_per_s": n_tok / wall,
                          "plain_wall_s": wall_plain, "logits_diff": diff,
                          "launches": counts, "flash_routes": routes}

    cache = init_cache(cfg, MUSICGEN_B, MUSICGEN_DECODE, f32)

    def step(t):
        return forward_decode(params, cfg, call,
                              {"frame_emb": frames[:, t:t + 1]}, cache, t)[0]

    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        errs = []
        t0 = time.perf_counter()
        for t in range(MUSICGEN_DECODE):
            errs.append((step(t) - ref[:, t]).abs().max())
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
        dcounts = _counts()
        worst = torch.stack(errs).max().item()
        window = range(MUSICGEN_DECODE - DECODE_PROFILE_STEPS,
                       MUSICGEN_DECODE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in window:
            step(t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(window)
        launches, dev_ms, top = _profile_window(
            lambda: [step(t) for t in window], len(window))
    ms_step = dwall / MUSICGEN_DECODE * 1e3
    busy = dev_ms / wall_ms if dev_ms > 0 else None
    log("examples", f"(b) decode {MUSICGEN_DECODE} positions at B = "
                    f"{MUSICGEN_B}, float32: {ms_step!r} ms/step; logits vs "
                    f"prefill max abs {worst!r} (tol {DECODE_TOL}); "
                    f"launches {dcounts}; steps {window.start}-"
                    f"{window.stop - 1} untraced {wall_ms!r} ms/step, traced "
                    f"{launches!r} device events/step, device busy "
                    f"{dev_ms!r} ms/step (busy share {busy!r})")
    for e in top:
        log("examples", f"  {e.self_device_time_total / len(window)!r} "
                        f"us/step x{e.count / len(window):g}/step  "
                        f"{e.key[:90]}")
    if not worst <= DECODE_TOL:
        raise AssertionError(f"musicgen decode off the prefill: {worst}")
    if dcounts["rmsnorm"] != want_rms * MUSICGEN_DECODE or \
            dcounts["flash_attention"]:
        raise AssertionError(f"musicgen decode launches {dcounts}")
    out["decode"] = {"ms_per_step": ms_step, "max_diff": worst,
                     "launches": dcounts, "window_ms": wall_ms,
                     "launches_per_step": launches,
                     "device_ms_per_step": dev_ms, "busy_share": busy}
    del params, cache, ref
    torch.cuda.empty_cache()

    # bf16 weights and compute: kernels and plain each against a float32
    # forward of the same weights
    p16 = init_params(cfg, 0, dtype=bf16)
    call16 = dataclasses.replace(call, compute_dtype=bf16)
    plain16 = dataclasses.replace(call16, kernel_backend="ref")
    with torch.no_grad():
        p32 = copy.deepcopy(p16).float()
        _, exact = run(p32, dataclasses.replace(plain16, compute_dtype=f32),
                       batch)
        del p32
        torch.cuda.empty_cache()
        warm = {"frame_emb": frames[:, :128]}
        forward_train(p16, cfg, call16, warm)
        forward_train(p16, cfg, plain16, warm)
        _reset_counts()
        wall16, k16 = run(p16, call16, batch)
        counts16 = _counts()
        routes16 = dict(fk.route_counts)
        walls16 = [wall16] + [run(p16, call16, batch)[0] for _ in range(2)]
        plain_walls16 = [run(p16, plain16, batch)[0] for _ in range(3)]
        _, q16 = run(p16, plain16, batch)
        plaunches, pdev_ms, _ = _profile_window(
            lambda: forward_train(p16, cfg, call16, batch), 1)
    errs16 = _bf16_errors(k16, q16, exact)
    scale = exact.abs().max().item()
    diff16 = (k16 - q16).abs().max().item()
    ok16 = bool(torch.isfinite(k16).all())
    del k16, q16, exact, p16
    torch.cuda.empty_cache()
    w16 = statistics.median(walls16)
    log("examples", f"(b) bf16 prefill: kernels {walls16!r} s, median "
                    f"{w16!r} s = {n_tok / w16!r} frames/s; plain "
                    f"{plain_walls16!r} s; logits vs a float32 forward "
                    f"(max |logit| {scale!r}): kernels {errs16['kernels']}, "
                    f"plain {errs16['plain']} (ratio at most "
                    f"{LOGITS_BF16_RATIO}); kernels vs plain {diff16!r}; "
                    f"launches {counts16}, flash by kernel {routes16}; one "
                    f"forward profiled: {plaunches!r} device events, busy "
                    f"{pdev_ms!r} ms of {w16 * 1e3!r} ms")
    if not ok16:
        raise AssertionError("musicgen bf16 prefill logits are not finite")
    check_launches("bf16 prefill", counts16, routes16, "tc")
    out["prefill_bf16"] = {"wall_s": w16, "walls_s": walls16,
                           "frames_per_s": n_tok / w16,
                           "plain_walls_s": plain_walls16,
                           "logits_err_vs_f32": errs16,
                           "logits_scale": scale, "logits_diff": diff16,
                           "launches": counts16, "flash_routes": routes16,
                           "profile_events": plaunches,
                           "device_ms": pdev_ms,
                           "busy_share": (pdev_ms / (w16 * 1e3)
                                          if pdev_ms > 0 else None)}

    _reset_counts()
    served = serve(MUSICGEN_ARCH, reduced=False, batch=4, prompt_len=16,
                   gen=32, verbose=False)
    toks = served["tokens"]
    n_steps = 16 + 32 - 1
    log("examples", f"(b) serve({MUSICGEN_ARCH!r}, reduced=False, batch=4, "
                    f"prompt_len=16, gen=32): {served['seconds']!r} s = "
                    f"{served['seconds'] / n_steps * 1e3!r} ms a decode "
                    f"step ({n_steps} steps), tokens {toks.shape}, first "
                    f"{toks[0, :16].tolist()}")
    if toks.shape != (4, 32) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"musicgen serve returned {toks.shape}")
    out["serve_s"] = served["seconds"]
    out["serve_ms_per_step"] = served["seconds"] / n_steps * 1e3
    out["params"] = n_params
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log("examples", f"(b) peak memory {out['peak_bytes']} B")
    return out


def phase_examples(results: dict) -> None:
    """Phase 21: (a) the four examples on the card, (b) musicgen-medium at
    full width and depth; (c), its kernel cases, ran in phases 7 and 12."""
    out = examples_on_card()
    out["musicgen"] = musicgen_on_card()
    results["examples"] = out


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
    red = results["reduced"]
    sk = red["mandator-sporades"]["kernel"]
    mg = results["examples"]["musicgen"]
    return [{
        "name": "channel_ring_commit",
        "route": "cuda",
        "source": "src/repro_torch/csrc/channel_ring.cu",
        "replaces": "src/repro/kernels/channel_ring/kernel.py:36",
        "launches": results["launches"],
        # on the main path the wrapper launches for the warm-up tick and
        # into the graph it captures; the graph's replays launch the rest
        "graph_launches": results["graph_launches"],
        "commits": results["commits"],
        "max_abs_err": results["max_abs_err"],
        "ms": sp["ms"],
        "plain_ms": sp["plain_ms"],
        "bound_ms": sp["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "prep_ms": sp["prep_ms"],
        "per_layout": results["per_layout"],
        "tick_profile": results.get("profile"),
        "launches_per_tick": {
            "mandator-sporades": results["commits"] / 10_000,
            **{p: results["protocols"][p]["launches_per_tick"]
               for p in ("mandator-paxos", "multipaxos", "mandator")}},
        "protocol_grids": {p: results["protocols"][p]
                           for p in ("mandator-paxos", "multipaxos",
                                     "mandator")},
        "workload_matrix": results["workloads"]["matrix"],
        "robustness_telemetry": results["workloads"]["robustness"],
        "launches_reduced": {p: red[p]["launches"]["channel_ring_commit"]
                             for p in ("mandator-sporades", "multipaxos")},
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
        "launches_dbrx_prefill":
            results["moe"]["prefill"]["launches"]["rmsnorm"],
        "dbrx_prefill_case": results["moe"]["rmsnorm"],
        "launches_xlstm_prefill": {
            k: results["xlstm"][k]["launches"]["rmsnorm"]
            for k in ("f32", "bf16")},
        "xlstm_prefill_cases": results["xlstm"]["rmsnorm"],
        "launches_vision_prefill":
            results["vision"]["prefill"]["launches"]["rmsnorm"],
        "vision_prefill_case": results["vision"]["rmsnorm"],
        "launches_musicgen": {
            "prefill_f32": mg["prefill_f32"]["launches"]["rmsnorm"],
            "prefill_bf16": mg["prefill_bf16"]["launches"]["rmsnorm"],
            "decode_step": mg["decode"]["launches"]["rmsnorm"]
            / MUSICGEN_DECODE},
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
        "launches_dbrx_prefill":
            results["moe"]["prefill"]["launches"]["flash_attention"],
        "dbrx_prefill_case": results["moe"]["flash"],
        "launches_vision_prefill":
            results["vision"]["prefill"]["launches"]["flash_attention"],
        "vision_prefill_case": results["vision"]["flash"],
        "launches_musicgen_prefill": {
            "f32": mg["prefill_f32"]["flash_routes"],
            "bf16": mg["prefill_bf16"]["flash_routes"]},
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
        "kernel": dec["kernel"],
        "loads_only_ms": dec["loads_only_ms"],
        "ms_bf16": dec16["ms"],
        "library_ms_bf16": dec16["library_ms"],
        "bound_ms_bf16": dec16["bound_ms"],
        "path": results["decode_attention_path"],
        "cases": results["decode_attention"],
    }, {
        "name": "sketch_buckets",
        "route": "cuda",
        "source": "src/repro_torch/csrc/sketch_buckets.cu",
        # no Pallas kernel stands behind it: the reference's jnp
        # scatter-adds of the sketch's buckets
        "replaces": "src/repro/distributed/sketch.py:47",
        "replaces_kind": "jnp (no pallas_call)",
        "launches": red["mandator-sporades"]["launches"]["sketch_buckets"],
        "max_abs_err": sk["max_abs_err"],
        "ms": sk["ms"],
        "plain_ms": sk["plain_ms"],
        "bound_ms": sk["bound_ms"],
        "bound_by": "bytes",
        "library_ms": sk["library_ms"],
        "max_abs_err_card_plain": sk["max_abs_err_card_plain"],
        "multipaxos": red["multipaxos"]["kernel"],
        "reduced_sweeps": red,
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
                 + f"; decode split kernels ({dk.stage()} keys a ring "
                 "stage; occupancy calculator's CTAs per SM, dynamic "
                 "shared memory): "
                 + "; ".join(f"{name} D={d} {dk.ctas_per_sm(dt, d, g, 0)} "
                             f"CTAs {dk.smem_bytes(dt, d)} B"
                             for name, dt, g in (
                                 ("decode_tf32_kernel G<=8", torch.float32,
                                  8),
                                 ("decode_tf32_kernel G>8", torch.float32,
                                  16),
                                 ("decode_bf16_kernel", torch.bfloat16, 16))
                             for d in dk.HEAD_DIMS))

    results: dict = {"dryrun_cells": start_dryrun_cells()}
    start = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        fn(*args)
        log("time", f"{name} {time.perf_counter() - t!r} s (run so far "
                    f"{time.perf_counter() - start!r} s)")

    try:
        run_phases(results, timed)
    finally:
        proc = results["dryrun_cells"][0]
        if proc.poll() is None:                # a phase failed first
            proc.kill()
            proc.wait()
    log("time", f"all phases {time.perf_counter() - start!r} s")

    kernels = kernel_entries(results)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(results: dict, timed) -> None:
    timed("kernel", phase_kernel, results)
    timed("main", phase_main, results)
    timed("profile", phase_profile, results)
    timed("whole path", phase_whole_path)
    timed("graph", phase_graph, results)
    timed("protocols", phase_protocols, results)
    timed("dispatch", phase_dispatch, results)
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
    timed("workloads", phase_workloads, results)
    timed("reduced sweeps", phase_reduced, results)
    timed("train", phase_train, results)
    timed("moe", phase_moe, results)
    timed("xlstm", phase_xlstm, results)
    timed("vision", phase_vision, results)
    timed("mesh", phase_mesh, results)
    timed("examples", phase_examples, results)
    _reset_counts()
    from repro_torch.core import compile_cache
    tot = _PROGRAM_TOTALS
    log("graph", f"the whole script: {tot['captures']} tick programs "
                 f"captured in {tot['capture_s']!r} s "
                 f"({tot['capture_s'] / max(tot['captures'], 1)!r} s "
                 f"each), {tot['replays']} replays launching "
                 f"{tot['graph_kernel_launches']} kernels, "
                 f"{tot['eager_ticks']} ticks run eagerly, "
                 f"{compile_cache.programs()} programs held at the end")


if __name__ == "__main__":
    sys.exit(main())
