"""Find a cell's configuration, traffic mix and per-layer metrics by name.

``BENCHMARK.json`` names everything; the files sit beside this module:

* ``configs/``: each configuration's ``file`` entry (a JSON object with the
  deployment's ``protocol`` and ``smr`` settings);
* ``traffic/<traffic>.json``: a cell's mix (the grid's axes, run length,
  telemetry, how many lanes the check re-simulates);
* ``metrics/<name>.py``: one reader per per-layer metric, a function
  ``read(obs) -> float | None``.

Adding a configuration, a mix or a metric takes new files and new entries
in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass(frozen=True)
class Cell:
    """One ``workloads`` entry with everything it names, loaded."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    base: Path = HERE               # the benchmark's directory

    def reader(self, name: str) -> Callable:
        """The reader of the per-layer metric ``name``."""
        return reader(name, self.base)


def load_benchmark(path: Optional[Path] = None) -> Dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_json(rel: str, base: Path = ROOT) -> Dict:
    with open(base / rel) as f:
        return json.load(f)


def cell(bench: Dict, name: str, base: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``; raises KeyError for an unknown
    name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: "
                       f"{', '.join(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(configs[w["config"]]["file"], base)
    traffic = load_json(f"perfbench/traffic/{w['traffic']}.json", base)

    def metrics(key):
        return [Metric(m["name"], m["unit"]) for m in bench[key]
                if _applies(m, name)]
    return Cell(name, int(w["chips"]), cfg, traffic, metrics("end_to_end"),
                metrics("per_layer"), base / "perfbench")


def reader(name: str, base: Path = HERE) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
