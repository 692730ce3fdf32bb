"""The comparison that decides ``correct``.

Once the window has closed, a sample of the lanes of one of its grids,
drawn from the run's seed, is simulated again by the plain reference
(``plainsim``: the paper's protocols written out in NumPy, sharing no code
with the port) from the same draw table, each lane under its scenario's
tables (``plainscen``), as one batch on the host's CPU.
The sample takes a lane of every rate, scenario and workload of the grid
(the grid's highest rate first) and random lanes besides, ``CHECK_LANES``
in all at the least. Every value of each port row is held to the
reference's row: scalars, timelines, per-origin quantiles, and under
Sporades the committed vector clocks and commit keys of every tick.
Integer, boolean and string values, dtypes, shapes and keys must be equal
(``exact_mismatches``, limit 0); a float value is measured by its distance
from the reference's in float32 units in the last place (``max_ulps``, a
NaN equal to a NaN), against ``MAX_ULPS``.

``precision="bfloat16"`` runs the control instead: the reference with the
float32 arrays of its state rounded to bfloat16 after every tick, the
precision step below the configuration's float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import pb_inputs
import plainscen
import plainsim

# the fewest lanes a run checks; the largest float distance it admits, in
# float32 units in the last place
CHECK_LANES = 6
MAX_ULPS = 8


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance of float values in float32 units in the last place: both
    cast to float32, each mapped to its place in the float32 order (+0 and
    -0 one place); a NaN against a NaN is 0, a NaN against a number is
    ``UNMATCHED``."""
    a32 = np.asarray(a, np.float32)
    b32 = np.asarray(b, np.float32)

    def place(x):
        u = x.view(np.uint32).astype(np.int64)
        return np.where(u & 0x80000000, -(u & 0x7FFFFFFF), u)
    d = np.abs(place(a32) - place(b32))
    na, nb = np.isnan(a32), np.isnan(b32)
    d = np.where(na & nb, 0, d)
    return np.where(na ^ nb, UNMATCHED, d)


# the distance a value with no counterpart counts as (a NaN against a
# number, a differing shape or dtype, a missing key)
UNMATCHED = 2 ** 32


def compare_rows(port, ref, out: Optional[Dict] = None, at: str = ""
                 ) -> Dict:
    """Compare a port row with the reference's (nested dicts of scalars
    and arrays). Returns ``out``: ``exact_mismatches`` (integer, boolean
    and string values, dtypes, shapes and keys that differ; each differing
    element counts one), ``max_ulps`` (the largest float32 distance of a
    float value) and ``paths`` (the key paths that differ at all, with
    their count)."""
    out = out if out is not None else {"exact_mismatches": 0,
                                       "max_ulps": 0, "paths": {}}
    if isinstance(ref, dict) or isinstance(port, dict):
        if not (isinstance(ref, dict) and isinstance(port, dict)):
            return _exact(out, at, 1)
        for k in set(ref) | set(port):
            if k in port and k in ref:
                compare_rows(port[k], ref[k], out, f"{at}.{k}")
            else:
                _exact(out, f"{at}.{k}",
                       max(1, np.size(port.get(k, ref.get(k)))))
        return out
    if isinstance(ref, str) or isinstance(port, str):
        return _exact(out, at, int(ref != port))
    a, b = np.asarray(port), np.asarray(ref)
    if a.dtype != b.dtype or a.shape != b.shape:
        return _exact(out, at, max(a.size, b.size, 1))
    if a.dtype.kind == "f":
        d = ulps(a, b)
        worst = int(d.max()) if d.size else 0
        if worst:
            out["max_ulps"] = max(out["max_ulps"], worst)
            out["paths"][at] = out["paths"].get(at, 0) + int(
                np.count_nonzero(d))
        return out
    return _exact(out, at, int(a.size - np.count_nonzero(a == b)))


def _exact(out: Dict, at: str, n: int) -> Dict:
    if n:
        out["exact_mismatches"] += n
        out["paths"][at] = out["paths"].get(at, 0) + n
    return out


def sample_lanes(seed: int, grids: Sequence, count: int = CHECK_LANES
                 ) -> Tuple[int, List[int]]:
    """(grid index, lanes): lanes of one of the collected grids, all drawn
    from the seed: first a lane at the grid's highest rate, then one of
    every other rate, one at the highest rate of every scenario and every
    workload not yet in the sample, then random lanes up to ``count``. One
    grid, so that the reference runs them as the lanes of one batch."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, 0xC0FFEE]))
    k = int(rng.integers(len(grids)))
    pts = grids[k].points
    top = max(p[0] for p in pts)
    chosen: List[int] = []

    def take(ok):
        if not any(ok(pts[i]) for i in chosen):
            pool = [i for i, p in enumerate(pts) if ok(p)]
            chosen.append(int(pool[int(rng.integers(len(pool)))]))
    take(lambda p: p[0] == top)
    for r in sorted({p[0] for p in pts}, reverse=True):
        take(lambda p, r=r: p[0] == r)
    for axis in (2, 3):
        for v in sorted({p[axis] for p in pts}):
            take(lambda p, a=axis, v=v: p[a] == v and p[0] == top)
    rest = [int(i) for i in rng.permutation(len(pts)) if i not in chosen]
    return k, chosen + rest[:max(0, count - len(chosen))]


def reference_rows(protocol: str, config: Dict, traffic: Dict, grid,
                   lanes: Sequence[int], precision: str = "float32"
                   ) -> List[Dict]:
    """The reference's rows of ``lanes`` of ``grid``, in that order, each
    lane under its scenario's tables (``plainscen``); the delay horizon is
    sized over every scenario of the grid, as the port sizes its ring."""
    settings = pb_inputs.smr_settings(config, traffic)
    tabs = [plainscen.lower(settings, x) for x in grid.scenarios]
    dep = plainsim.deployment(config, traffic.get("smr"), tabs)
    labels, lane_tabs = [], []
    for i in lanes:
        rate, seed, fi, wi = grid.points[i]
        labels.append({"protocol": protocol, "rate": rate, "seed": seed,
                       "workload": grid.workloads[wi]})
        lane_tabs.append(tabs[fi])
    return plainsim.lane_rows(protocol, dep, pb_inputs.take_lanes(
        grid, lanes), plainscen.stack(lane_tabs), labels, precision)


def compare(port_rows: Sequence[List[Dict]], grids: Sequence, gi: int,
            lanes: Sequence[int], ref_rows: Sequence[Dict]) -> Dict:
    """The check's numbers over ``lanes`` of grid ``gi``:
    ``exact_mismatches``, ``max_ulps`` (``compare_rows``),
    ``lanes_checked``, and ``rows_short`` (grid points without a row, over
    every grid of the window); besides, the lanes that differ at all."""
    short = sum(max(0, g.lanes - len(rows))
                for g, rows in zip(grids, port_rows))
    total = {"exact_mismatches": 0, "max_ulps": 0, "paths": {}}
    checked, where, rows = 0, [], port_rows[gi]
    for lane, ref in zip(lanes, ref_rows):
        if lane >= len(rows):
            continue
        one = compare_rows(rows[lane], ref)
        checked += 1
        total["exact_mismatches"] += one["exact_mismatches"]
        total["max_ulps"] = max(total["max_ulps"], one["max_ulps"])
        for k, v in one["paths"].items():
            total["paths"][k] = total["paths"].get(k, 0) + v
        if one["paths"]:
            rate, _, fi, wi = grids[gi].points[lane]
            where.append([gi, lane, rate, grids[gi].scenarios[fi],
                          grids[gi].workloads[wi], one["exact_mismatches"],
                          one["max_ulps"]])
    return dict(total, lanes_checked=checked, rows_short=short, where=where)
