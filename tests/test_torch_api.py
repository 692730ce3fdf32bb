"""Keeps the port's module gap closed: every public top-level name of each
``src/repro/`` module exists in its counterpart under ``src/repro_torch/``
(``analysis/hlo_lint`` -> ``analysis/graph_lint``, ``distributed/
hlo_analysis`` -> ``distributed/graph_analysis``), or stands in ``TABLE``
below: a rename with its port name, or no counterpart with the reason.
Both packages are read with ``ast``; nothing is imported."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
MODULE_RENAMES = {"analysis/hlo_lint.py": "analysis/graph_lint.py",
                  "distributed/hlo_analysis.py":
                      "distributed/graph_analysis.py"}

_CACHE = ("none: the reference's persistent XLA cache and on-disk program "
          "store; a CUDA graph holds one process's device pointers and "
          "cannot be saved, so the port keeps its kernel libraries "
          "(kernels/_build.py) and captures each tick program once per "
          "process (compile_cache.start)")
_NEG_INF = ("none: the port's kernels mask with -INFINITY inside their CUDA "
            "source (csrc/*.cu); no Python constant feeds them")

# reference module -> {name: port name ("module.py:name" when it lives in
# another module) or a reason starting "none:"}
TABLE = {
    "core/compile_cache.py": dict.fromkeys(
        ("DISABLE_ENV", "cache_dir", "default_cache_dir", "disable",
         "enable", "enabled", "ensure", "program_dir",
         "source_fingerprint"), _CACHE),
    "core/experiment.py": {
        "CANONICAL_LANES": "none: the port runs a grid's points as the "
                           "lanes of one program (ProgramSignature.lanes "
                           "is the grid's width), where the reference "
                           "pins its program to one lane",
        "trace_counts": "capture_counts",
        "reset_trace_counts": "reset_capture_counts"},
    "distributed/hlo_analysis.py": {
        "ICI_BW": "INTERCONNECT_BW",
        "while_stats": "none: no HLO while loop; the port's tick loop is "
                       "n_ticks - 1 replays of one captured graph, counted "
                       "by core/compile_cache.stats() (graph_runs, "
                       "replays)",
        "loop_computations": "graph_kernel_nodes",
        "opcode_cost": "none: per-op bytes of eager PyTorch are "
                       "record_cost's CostOp list, summed by module_cost; "
                       "no HLO opcodes",
        "total_collective_bytes": "collective_stats"},
    "kernels/channel_ring/kernel.py": {
        "NEG": "core/channel.py:NEG",
        "ring_commit_tpu": "ring_commit_fused"},
    "kernels/channel_ring/ops.py": {"BACKENDS": "kernels/_dispatch.py:BACKENDS"},
    "kernels/decode_attention/kernel.py": {
        "NEG_INF": _NEG_INF, "decode_attention_pallas": "decode_attention_cuda"},
    "kernels/flash_attention/kernel.py": {
        "NEG_INF": _NEG_INF, "flash_attention_bhsd": "flash_attention_cuda"},
    "kernels/rmsnorm/kernel.py": {"rmsnorm_2d": "rmsnorm_cuda"},
    "kernels/ssm_scan/kernel.py": {"ssm_scan_pallas": "ssm_scan_cuda"},
    "launch/dryrun.py": {
        "ART": "none: the reference's fixed artifact folder under "
               "benchmarks/; the port's dry run writes only under the "
               "caller's --out"},
    "models/model.py": {
        "Params": "none: a type alias of the reference's signatures; the "
                  "port annotates its parameter trees as Dict"},
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _targets(node):
    for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
        for x in ([t] if isinstance(t, ast.Name) else
                  t.elts if isinstance(t, ast.Tuple) else []):
            if isinstance(x, ast.Name):
                yield x.id


def _public(path: Path, imports: bool) -> set:
    """Top-level public names a module defines (and, with ``imports``,
    those it imports: an ``__init__`` re-exports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _port(rel: str) -> Path:
    return PORT / MODULE_RENAMES.get(rel, rel)


def test_the_table_names_reference_modules():
    assert set(TABLE) <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_is_ported_or_listed(rel):
    port = _port(rel)
    assert port.exists(), f"{rel} has no counterpart {port}"
    want = _public(REF / rel, imports=rel.endswith("__init__.py"))
    have = _public(port, imports=True)
    table = TABLE.get(rel, {})
    missing = sorted(want - have - set(table))
    assert not missing, f"{rel}: {missing} neither ported nor in TABLE"
    for name, entry in table.items():
        assert name in want, f"{rel}: TABLE lists {name}, no public name"
        assert name not in have, f"{rel}: {name} is ported; drop its entry"
        if entry.startswith("none:"):
            continue
        where, _, target = entry.rpartition(":")
        assert target in _public(PORT / where if where else port,
                                 imports=True), f"{rel}: {entry} not found"
