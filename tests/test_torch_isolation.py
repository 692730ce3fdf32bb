"""The port stands alone: src/repro_torch, chip_smoke.py and the port's
examples (examples/torch_*.py) import neither JAX nor anything of the JAX
package ``repro``, and the entry points do not fall back to the CPU on
their own."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


def _example(path):
    """An example script as a module, imported by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [m for m in names if _forbidden(m)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_every_module_imports_without_jax():
    """In a fresh interpreter where importing jax or repro fails, every
    repro_torch module, chip_smoke and each examples/torch_*.py import."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import importlib.util\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    s = importlib.util.spec_from_file_location('ex', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50
    assert len(EXAMPLES) == 4


def test_entry_points_default_to_cuda():
    """Without device=, the entry points ask for CUDA: on a host without a
    card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    from repro_torch.configs import get_config
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import mandator, netsim, paxos, sporades
    from repro_torch.core.experiment import SweepSpec, run_sweep
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_cache, init_params
    cfg = SMRConfig(sim_seconds=0.1, delay_horizon_ticks=256)
    lm = get_config("smollm-135m").reduced()
    for call in (
            lambda: run_sweep("mandator-sporades", cfg,
                              SweepSpec(rates=(1000,))),
            lambda: run_sweep("multipaxos", cfg, SweepSpec(rates=(1000,))),
            lambda: paxos.init_state(cfg, 100, True),
            lambda: netsim.build_env(cfg),
            lambda: mandator.init_state(cfg, 100),
            lambda: sporades.init_state(cfg, 100),
            lambda: init_params(lm, 0),
            lambda: init_cache(lm, 1, 8),
            lambda: serve("smollm-135m", batch=1, prompt_len=2, gen=2,
                          verbose=False),
            lambda: make_production_mesh(),
            lambda: make_debug_mesh(1, 1),
            lambda: dryrun.run_cell("smollm-135m", "train_4k",
                                    verbose=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # each example's main() without --device (an empty argv: pytest's own
    # arguments are not the example's)
    for path in EXAMPLES:
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(path).main([])
