"""The Sporades tick's two routes on the CPU: a CPU state takes the op
chain (new tensors, the ``order.chain_calls`` counter), the kernel route
on it raises before anything runs, the kernel's wrapper refuses CPU
tensors, its scratch buffers and parameter struct match the CUDA source's
layout, and the op chain's transition masks cover every branch on the
grids the card's parity test runs. The kernel itself runs only on the
card (tests/test_torch_sporades_tick_cuda.py). The grids are set up by
chip_smoke.py's ``sporades_lanes``, as the card's pairs are."""
import ctypes
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs.smr import SMRConfig
from repro_torch.core import mandator, spans
from repro_torch.core import sporades
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.kernels.sporades_tick import kernel

SOURCE = (Path(kernel.__file__).resolve().parents[2] / "csrc"
          / "sporades_tick.cu")
_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
TRANSITIONS = smoke.TICK_TRANSITIONS
_clone = smoke._clone


def _grid(sim_s=0.05, view_timeout_ms=300.0, rates=(100_000, 300_000),
          seeds=(0,), scenario="baseline", n_replicas=5):
    """A mandator-sporades grid on the CPU at tick 0: (cfg, env, arrivals,
    Mandator's state, Sporades', t)."""
    return smoke.sporades_lanes(scenario, sim_s, view_timeout_ms, rates,
                                seeds, n_replicas=n_replicas, device="cpu")


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_cpu_state_takes_the_op_chain():
    cfg, env, arr, m, st, t = _grid()
    m = mandator.tick(m, t, arr, env, cfg)
    before = _clone(st)
    spans.reset()
    out = sporades.tick(st, t, env, cfg, m["lcr"])
    c = spans.stats()["counters"]
    assert c == {"order.chain_calls": 1}
    # the op chain returns new tensors and leaves its input as it was
    # (the ring is committed in place on both routes)
    assert out["v_cur"] is not st["v_cur"]
    rest = lambda s: {k: v for k, v in s.items() if k != "ring"}  # noqa
    assert _equal(rest(st), rest(before))
    # the chain's own state is tick's
    want, fired = sporades._tick_chain(before, t, env, cfg, m["lcr"])
    assert _equal(out, want)
    assert set(fired) == set(TRANSITIONS)
    assert all(v.shape == st["v_cur"].shape and v.dtype == torch.bool
               for v in fired.values())
    again = sporades.tick(_clone(before), t, env, cfg, m["lcr"])
    assert _equal(again, want)
    assert spans.stats()["counters"] == {"order.chain_calls": 2}


def test_kernel_route_on_a_cpu_state_raises_before_anything_runs():
    cfg, env, arr, m, st, t = _grid()
    m = mandator.tick(m, t, arr, env, cfg)
    before, launches = _clone(st), kernel.launch_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        sporades._tick_kernel(st, t, env, cfg, m["lcr"])
    assert _equal(st, before) and kernel.launch_count == launches


def test_kernel_wrapper_refuses_cpu_tensors():
    cfg, env, arr, m, st, t = _grid()
    launches = kernel.launch_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.sporades_tick(st, t, env, m["lcr"], 300.0, [(0, 0)] * 6)
    assert kernel.launch_count == launches


@pytest.mark.parametrize("protocol,chain_calls", [
    ("mandator-sporades", 50), ("mandator-paxos", 0), ("multipaxos", 0)])
def test_sweep_counts_one_chain_call_a_tick(protocol, chain_calls):
    spans.reset()
    run_sweep(protocol, SMRConfig(sim_seconds=0.05),
              SweepSpec(rates=(100_000,)), device="cpu")
    c = spans.stats()["counters"]
    assert c.get("order.chain_calls", 0) == chain_calls
    assert "order.kernel_calls" not in c


@pytest.mark.parametrize("n", [3, 5, 9])
def test_scratch_layout(n):
    B = 3
    sc = kernel.scratch(B, n, torch.device("cpu"))
    assert kernel.scratch(B, n, torch.device("cpu")) is sc   # made once
    spec = sporades.ring_spec(n)
    widths = kernel.widths(n)
    assert sc["pay"].shape == (B, n, sum(widths))
    assert sc["pay_off"] == tuple(sum(widths[:e])
                                  for e in range(len(widths)))
    assert [s[0] for s in sc["sends"]] == list(kernel.SENDS)
    for e, (name, pay, mask) in enumerate(sc["sends"]):
        assert widths[e] == spec[name].width
        assert pay.shape == (B, n, n, widths[e]) and pay.stride()[2] == 0
        assert pay.data_ptr() == sc["pay"].data_ptr() \
            + sc["pay_off"][e] * 4
        assert mask.shape == (B, n, n) and mask.dtype == torch.bool
    assert sc["mask"].shape == (len(kernel.SENDS), B, n, n)
    assert sc["delay"].dtype == torch.int32 and sc["drop"].shape == (B, n, n)
    assert sc["cut"].shape == (B, n) and sc["cut"].dtype == torch.int32
    # the channels the kernel's enum names, in the ring's own order
    assert kernel.CHANNELS == tuple(c.name for c in spec.channels)


def _struct_fields(src: str) -> list:
    """The member names of csrc's ``struct Params``, in order."""
    body = src[src.index("struct Params {"):]
    body = body[body.index("{") + 1:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for stmt in body.split(";"):
        stmt = re.sub(r"\[[^\]]*\]", "", stmt).strip()
        if not stmt:
            continue
        stmt = stmt.removeprefix("const ").strip()
        rest = stmt.split(None, 1)[1]
        names += [x.strip().lstrip("*") for x in rest.split(",")]
    return names


def test_params_struct_matches_the_source():
    src = SOURCE.read_text()
    size = int(re.search(r"sizeof\(Params\) == (\d+)", src).group(1))
    assert ctypes.sizeof(kernel.Params) == size
    assert int(re.search(r"kMaxN = (\d+)", src).group(1)) == kernel.MAX_N
    assert _struct_fields(src) == [f[0] for f in kernel.Params._fields_]
    assert [name for name, _, _ in kernel.STATE] \
        == _struct_fields(src)[:len(kernel.STATE)]


def test_op_chain_covers_every_transition_on_the_parity_grid():
    """The card's parity test holds the kernel to the op chain on this
    grid (16 lanes, 512 ticks, a 60 ms view timeout): every transition of
    the tick fires on it, so no branch of the kernel goes unchecked."""
    cfg, env, arr, m, st, t = _grid(
        sim_s=0.512, view_timeout_ms=60.0,
        rates=(50_000, 150_000, 300_000, 450_000), seeds=(0, 1, 2, 3))
    total = dict.fromkeys(TRANSITIONS, 0)
    for _ in range(512):
        m = mandator.tick(m, t, arr, env, cfg)
        st, fired = sporades._tick_chain(st, t, env, cfg, m["lcr"])
        for k in TRANSITIONS:
            total[k] += int(fired[k].sum())
        t.add_(1)
    assert all(total.values()), total


@pytest.mark.parametrize("n,unfired", [(3, {"bfall"}), (9, set())])
def test_op_chain_covers_the_transitions_at_fig9_sizes(n, unfired):
    """The card's parity test also holds the kernel to the op chain at n =
    3 and n = 9 (baseline and leader-crash-recover, 60 ms, 512 ticks):
    there the n-dependent phases fire too (at n = 3 all but the Bfall
    catch-up, which the n = 5 and n = 9 cases cover)."""
    total = dict.fromkeys(TRANSITIONS, 0)
    for scenario in ("baseline", "leader-crash-recover"):
        cfg, env, arr, m, st, t = _grid(
            sim_s=0.512, view_timeout_ms=60.0,
            rates=(50_000, 150_000, 300_000, 450_000), seeds=(0, 1, 2, 3),
            scenario=scenario, n_replicas=n)
        for _ in range(512):
            m = mandator.tick(m, t, arr, env, cfg)
            st, fired = sporades._tick_chain(st, t, env, cfg, m["lcr"])
            for k in TRANSITIONS:
                total[k] += int(fired[k].sum())
            t.add_(1)
    assert {k for k, v in total.items() if not v} == unfired, total
