"""What the command loads, and where it refuses to run: the top-level name
of every module is compared whole (``repro_torch`` is the port,
``repro`` the JAX package); the reference imports nothing of either; the
command exits non-zero with no result without a CUDA device or without
the port beside it."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import pb_registry
import run


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"repro.core", "jax"} <= set(run.forbidden_modules())


def test_reference_and_harness_load_no_port_and_no_jax():
    code = ("import sys; sys.path.insert(0, 'perfbench');"
            "import run, pb_check, pb_inputs, pb_trace, pb_roofline;"
            "import plainsim, plainscen;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = _python(code, pb_registry.ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                       "torch"}


@pytest.mark.parametrize("module", ["plainsim.py", "plainscen.py"])
def test_reference_imports_numpy_alone(module):
    """The plain reference and its scenario tables read nothing of the
    port, of JAX or of torch: each module imports only NumPy and the
    standard library."""
    import ast
    tree = ast.parse((pb_registry.HERE / module).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names <= {"numpy", "math", "dataclasses", "typing",
                     "__future__", "annotations", "Dict", "List",
                     "Optional", "Sequence", "Tuple", "dataclass"}, names


def test_port_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['perfbench', 'src'];"
            "import run; run.Port('cpu');"
            "print(run.forbidden_modules())")
    out = _python(code, pb_registry.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_result(proc):
    lines = [x for x in proc.stdout.splitlines() if x.strip()]
    for line in lines:
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")


def test_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "paxos.fig6",
         "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=pb_registry.ROOT, capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode != 0
    _no_result(proc)


def test_refuses_in_a_bare_checkout(tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(pb_registry.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(pb_registry.ROOT / "BENCHMARK.json", root)
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "paxos.fig6",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    _no_result(proc)
