"""Client arrivals (open or closed loop) + batch bookkeeping, batched over
the grid (port of ``repro.core.workload``).

Arrivals are Poisson per tick per origin. The reference draws them inside
the tick from ``fold_in(PRNGKey(seed), t)``; the port reads them from an
``Arrivals`` bundle made before the tick loop:

  trivial — the §5.2 baseline: row t of the **draw table** ``[B, T, n]``
            (``draw_table``), drawn at ``rate_per_tick`` per origin;
  table   — the same, drawn at ``rate_per_tick x rate_of[win_of_tick[t]]``
            from the lane's compiled ``repro_torch.workloads`` table;
  closed  — the table instead sizes geo-placed client pools (Little's
            law) whose submission rate is gated on the requests in flight
            and capped at ``cap`` outstanding per origin. That mean
            depends on the state, so a closed lane cannot draw its table
            up front. It samples a time-changed unit-rate Poisson process
            instead: ``epoch_stream`` draws, before the loop, each origin's
            arrival epochs of a rate-1 process (cumulated Exp(1) gaps, in
            float64, from the lane's own ``torch.Generator``); each tick
            adds the tick's mean to the origin's cumulative intensity
            ``cl_lam_cum`` and takes the epochs it passed. Given the past,
            that count is exactly Poisson with the tick's mean; it needs
            no read-back inside the tick, and one epoch stream can be
            handed to the card and to the CPU alike.

Every lane draws from its own generator seeded with its seed, so a lane's
draws do not depend on the other lanes. Tests pass in the counts the
reference drew instead (``draws``; in closed mode, counts after the cap).

The float64 leaves (``cl_lam_cum`` here, the remainder in
``form_batches``) are deliberate: the intensity is compared with float64
epochs, and the remainder reproduces XLA-CPU's fused multiply-add.

Batch records are per-lane arrays indexed [lane, origin, round]:
  batch_create_t — tick when the batch was formed
  batch_arr_mean — mean arrival tick of its requests (execution latency)
  batch_count    — number of requests in the batch
Commit times are reconstructed after the run from the per-tick committed
vector-clock trace (harness._vc_commit_ticks). The closed-loop in-flight
decrement at commit lives in the harness (harness._closed_feedback),
which owns the commit signal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.workloads.compile import TRIVIAL_MODE, WorkloadMode

# epochs drawn past a closed lane's largest possible intensity, in
# standard deviations of the Poisson count, plus a floor
EPOCH_SIGMAS = 10.0
EPOCH_FLOOR = 64


@dataclass
class Arrivals:
    """What a tick's ``arrive`` reads. ``draws``: [B, T, n] float32 counts
    (every open lane's; in closed mode without ``epochs``, every lane's,
    closed lanes' counts after the cap — a replay). ``wlt``: the grid's
    workload tables, leaves [B, ...] (``rate_of`` [B, W, n],
    ``win_of_tick`` [B, T], ``closed``/``think_ticks``/``cap`` [B]).
    ``rate``: [B] float32 rate per origin per tick. ``epochs``: [B, n, M]
    float64 arrival epochs of the closed lanes' unit-rate processes
    (+inf rows for open lanes). ``cut``: [B] bool, set where the cap cut a
    replayed count."""
    draws: Optional[torch.Tensor]
    mode: WorkloadMode = TRIVIAL_MODE
    wlt: Optional[Dict[str, torch.Tensor]] = None
    rate: Optional[torch.Tensor] = None
    epochs: Optional[torch.Tensor] = None
    cut: Optional[torch.Tensor] = None

    @property
    def sampling(self) -> bool:
        """Closed lanes sample the epoch stream (else they replay)."""
        return self.mode.closed and self.epochs is not None


def init_workload(cfg: SMRConfig, n_ticks: int, batch: int,
                  device: torch.device, closed: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """Tick-0 workload state. ``closed`` adds the closed-loop counters and
    the closed lanes' sampler state (left at zero by a replay)."""
    n = cfg.n_replicas
    z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                               device=device)
    wl = {
        "buffer": z(batch, n),         # pending request count
        "buffer_tsum": z(batch, n),    # sum of arrival ticks
        "last_batch_t": z(batch, n),
        "cpu_tokens": z(batch, n),
        "batch_create_t": torch.full((batch, n, n_ticks), float("inf"),
                                     dtype=torch.float32, device=device),
        "batch_arr_mean": z(batch, n, n_ticks),
        "batch_count": z(batch, n, n_ticks),
    }
    if closed:
        wl["cl_submitted"] = z(batch, n)
        wl["cl_done"] = z(batch, n)
        # running prefix sum of batch_count by round (written at formation,
        # rounds are formed in order) so the commit feedback is a gather
        wl["batch_count_cum"] = z(batch, n, n_ticks)
        # lint: allow(dtype-hygiene): the closed loop's cumulative
        # intensity is compared with float64 epochs
        wl["cl_lam_cum"] = torch.zeros((batch, n), dtype=torch.float64,
                                       device=device)
        wl["cl_drawn"] = torch.zeros((batch, n), dtype=torch.int64,
                                     device=device)
    return wl


def _host(x) -> np.ndarray:
    """A table leaf on the host (numpy or a CPU tensor)."""
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _lane_rates(rate: float, wlt: Optional[Dict], b: int, n_ticks: int,
                n: int, device: torch.device) -> torch.Tensor:
    """[T, n] float32 mean per origin per tick of lane b; the rate table's
    float32 multipliers are gathered on the host."""
    lam = torch.full((n_ticks, n), float(rate), dtype=torch.float32,
                     device=device)
    if wlt is None:
        return lam
    mult = np.asarray(_host(wlt["rate_of"][b]), np.float32)[
        _host(wlt["win_of_tick"][b]).astype(np.int64)]
    return lam * _device.to_device(mult, device)


def draw_table(rate_per_tick: Sequence[float], seeds: Sequence[int],
               n_ticks: int, n: int, device: torch.device,
               wlt: Optional[Dict] = None) -> torch.Tensor:
    """[B, T, n] float32 Poisson arrival counts: lane b draws from its own
    ``torch.Generator`` seeded with ``seeds[b]`` at mean
    ``rate_per_tick[b]`` per origin per tick, times its rate table where
    ``wlt`` is given (the grid's tables on the host: nothing here reads
    the card). Closed lanes (``wlt["closed"] > 0``) draw nothing here:
    their rows are zeros (see ``epoch_stream``)."""
    rows = []
    for b, (lam, seed) in enumerate(zip(rate_per_tick, seeds)):
        if wlt is not None and float(wlt["closed"][b]) > 0:
            rows.append(torch.zeros((n_ticks, n), dtype=torch.float32,
                                    device=device))
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        rows.append(torch.poisson(
            _lane_rates(lam, wlt, b, n_ticks, n, device), generator=gen))
    return torch.stack(rows)


def epoch_count(rate: float, wlt: Dict, b: int) -> int:
    """Epochs to draw for closed lane b: its cumulative intensity cannot
    pass sum_t rate x rate_of[win_of_tick[t]] (the pool's full size every
    tick), so draw that many plus EPOCH_SIGMAS standard deviations of the
    count and EPOCH_FLOOR."""
    mult = np.asarray(torch.as_tensor(wlt["rate_of"][b]).cpu(),
                      # lint: allow(dtype-hygiene): host float64 bound of a
                      # lane's epoch count
                      np.float64)[
        np.asarray(torch.as_tensor(wlt["win_of_tick"][b]).cpu())]
    bound = float(np.max(np.sum(float(rate) * mult, axis=0)))
    return int(math.ceil(bound + EPOCH_SIGMAS * math.sqrt(bound)
                         + EPOCH_FLOOR))


def epoch_slots(count: int) -> int:
    """The epoch stream's width M for a largest lane count ``count``: the
    next power of two, at least EPOCH_FLOOR, so that grids whose counts
    differ a little share one shape (and one captured tick program). The
    +inf padding takes no arrival."""
    return max(EPOCH_FLOOR, 1 << (max(1, int(count)) - 1).bit_length())


def epoch_stream(rate_per_tick: Sequence[float], seeds: Sequence[int],
                 wlt: Dict, n_ticks: int, n: int,
                 device: torch.device) -> torch.Tensor:
    """[B, n, M] float64 arrival epochs of each closed lane's unit-rate
    Poisson processes, one per origin (cumulated Exp(1) gaps from the
    lane's own generator seeded with its seed); open lanes' rows, and
    closed lanes' rows past their own ``epoch_count``, are +inf. M is
    ``epoch_slots`` of the largest count. ``wlt``: the grid's tables on
    the host."""
    counts = [epoch_count(lam, wlt, b)
              if float(wlt["closed"][b]) > 0 else 0
              for b, lam in enumerate(rate_per_tick)]
    m = epoch_slots(max(counts))
    # lint: allow(dtype-hygiene): the closed lanes' epoch stream
    # is float64 (a time-changed unit-rate Poisson process)
    out = torch.full((len(counts), n, m), float("inf"), dtype=torch.float64,
                     device=device)
    for b, (c, seed) in enumerate(zip(counts, seeds)):
        if c == 0:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        # lint: allow(dtype-hygiene): the closed lanes' epoch stream
        # is float64 (a time-changed unit-rate Poisson process)
        gaps = torch.empty((n, c), dtype=torch.float64, device=device)
        gaps.exponential_(generator=gen)
        out[b, :, :c] = torch.cumsum(gaps, dim=1)
    return out


def epochs_overrun(wl: Dict, arr: Arrivals) -> Optional[torch.Tensor]:
    """After the run, on the device: a 0-dim bool, set where a closed
    lane's intensity passed the last epoch drawn for it, its last finite
    one (its counts would have been cut short). Rows of +inf alone (open
    lanes) hold no epoch. None when no lane samples a stream."""
    if not arr.sampling:
        return None
    finite = torch.isfinite(arr.epochs)
    last = torch.where(finite, arr.epochs, float("-inf")).amax(dim=-1)
    return ((wl["cl_lam_cum"] >= last) & finite.any(dim=-1)).any()


def raise_if_overrun(overrun: bool) -> None:
    """``epochs_overrun``'s flag, read on the host: raise if it is set."""
    if overrun:
        raise RuntimeError("a closed-loop lane ran past its epoch stream; "
                           "raise workload.EPOCH_SIGMAS")


def check_epochs(wl: Dict, arr: Arrivals) -> None:
    """``epochs_overrun`` read back at once: raise if a closed lane ran
    past its epoch stream."""
    flag = epochs_overrun(wl, arr)
    if flag is not None:
        raise_if_overrun(bool(flag))


def _at_tick(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Column ``t`` of a per-lane table [B, T, ...] -> [B, ...], indexed on
    the device."""
    return table.index_select(1, t.long().view(1))[:, 0]


def arrive(wl: Dict, arr: Arrivals, t: torch.Tensor,
           alive: torch.Tensor) -> Dict:
    """This tick's Poisson arrivals at each origin's clients; a down
    replica takes no requests. ``t``: the tick, a 0-dim int32 tensor (a
    Python int is converted)."""
    wl = dict(wl)
    t = _device.tick_index(t, alive.device)
    if not arr.mode.closed:
        cnt = _at_tick(arr.draws, t) * alive
    else:
        wlt = arr.wlt
        closed = (wlt["closed"] > 0)[:, None]
        inflight = wl["cl_submitted"] - wl["cl_done"]
        if arr.sampling:
            # pool size via Little's law at the sweep rate; submission is
            # gated on requests still in flight
            lanes = torch.arange(closed.shape[0], device=closed.device)
            mult = wlt["rate_of"][lanes,
                                  _at_tick(wlt["win_of_tick"], t).long()]
            rate = arr.rate[:, None]
            think = wlt["think_ticks"][:, None]
            clients = rate * think * mult
            # a tensor divisor: CUDA divides by a Python scalar as a
            # product with its reciprocal
            lam = torch.clamp(clients - inflight, min=0.0) / think
            # lint: allow(dtype-hygiene): the cumulative intensity
            # accumulates in float64, as the epochs it is compared with
            lam_cum = wl["cl_lam_cum"] + torch.where(closed, lam,
                                                     0.0).double()
            seen = torch.searchsorted(arr.epochs, lam_cum[..., None],
                                      right=True)[..., 0]
            drawn = (seen - wl["cl_drawn"]).float()
            wl["cl_lam_cum"], wl["cl_drawn"] = lam_cum, seen
            open_cnt = _at_tick(arr.draws, t) if arr.draws is not None \
                else 0.0
            cnt = torch.where(closed, drawn, open_cnt) * alive
        else:
            cnt = _at_tick(arr.draws, t) * alive
        # capped at `cap` outstanding per origin
        room = torch.clamp(wlt["cap"][:, None] - inflight, min=0.0)
        capped = torch.where(closed, torch.minimum(cnt, room), cnt)
        if not arr.sampling:
            arr.cut |= (capped != cnt).flatten(1).any(dim=1)
        cnt = capped
        wl["cl_submitted"] = wl["cl_submitted"] + cnt
    wl["buffer"] = wl["buffer"] + cnt
    # a float32 product with float32(t), as the reference's cnt * t
    wl["buffer_tsum"] = wl["buffer_tsum"] + cnt * t
    return wl


def refill_cpu(wl: Dict, cpu_req_per_tick: torch.Tensor) -> Dict:
    """cpu_req_per_tick: [B]."""
    wl = dict(wl)
    wl["cpu_tokens"] = torch.clamp(
        wl["cpu_tokens"] + cpu_req_per_tick[:, None], max=1e7)
    return wl


def form_batches(wl: Dict, t: torch.Tensor, can_form: torch.Tensor,
                 round_idx: torch.Tensor, batch_size: int,
                 batch_ticks: float
                 ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """can_form: [B, n] bool (protocol gate, e.g. ~awaitingAcks & alive).
    round_idx: [B, n] int32 — the chain round the new batch would get.
    Returns (wl, formed [B, n] bool, count [B, n] float). The batch
    records are updated in place. ``t``: the tick, a 0-dim int32 tensor
    (a Python int is converted)."""
    wl = dict(wl)
    t = _device.tick_index(t, can_form.device)
    tf = t.float()
    inf = float("inf")
    size_ok = wl["buffer"] >= batch_size
    time_ok = (t - wl["last_batch_t"] >= batch_ticks) & (wl["buffer"] > 0)
    formed = can_form & (size_ok | time_ok) & (wl["cpu_tokens"] >= 1.0)
    count = torch.where(
        formed, torch.minimum(torch.clamp(wl["buffer"], max=batch_size),
                              wl["cpu_tokens"]), 0.0)
    frac = torch.where(wl["buffer"] > 0,
                       count / torch.clamp(wl["buffer"], min=1.0), 0.0)
    tsum_taken = wl["buffer_tsum"] * frac
    arr_mean = torch.where(count > 0,
                           tsum_taken / torch.clamp(count, min=1.0), 0.0)
    idx = torch.clamp(round_idx, 0, wl["batch_create_t"].shape[2] - 1
                      ).long()[..., None]
    wl["batch_create_t"].scatter_reduce_(
        2, idx, torch.where(formed, tf, inf)[..., None], "amin",
        include_self=True)
    wl["batch_arr_mean"].scatter_add_(
        2, idx, torch.where(formed, arr_mean, 0.0)[..., None])
    wl["batch_count"].scatter_add_(2, idx, count[..., None])
    if "batch_count_cum" in wl:
        cum = wl["batch_count_cum"]
        prev = torch.gather(cum, 2, torch.clamp(idx - 1, min=0))[..., 0]
        cur = torch.gather(cum, 2, idx)[..., 0]
        cum.scatter_(2, idx, torch.where(formed, prev + count,
                                         cur)[..., None])
    wl["buffer"] = wl["buffer"] - count
    # the reference's `buffer_tsum - tsum_taken` (src/repro/core/workload.py
    # :106,122) is contracted by XLA on the CPU into one fused multiply-add
    # of buffer_tsum and frac, rounded once; the float32 product of two
    # float32 values is exact in float64, so this rounds as the FMA does
    # lint: allow(dtype-hygiene): the fused multiply-add's one rounding
    tsum = wl["buffer_tsum"].double()
    # lint: allow(dtype-hygiene): the fused multiply-add's one rounding
    wl["buffer_tsum"] = (tsum - tsum * frac.double()).float()
    wl["cpu_tokens"] = wl["cpu_tokens"] - count
    wl["last_batch_t"] = torch.where(formed, tf, wl["last_batch_t"])
    return wl, formed, count
