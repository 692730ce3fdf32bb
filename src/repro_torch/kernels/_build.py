"""Build a CUDA source of the package into a shared library with a plain C
interface and load it with ctypes.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
source in the checkout alone, into ``build/kernels/`` at the root of the
checkout (``.gitignore`` lists it; ``REPRO_TORCH_BUILD_DIR`` overrides the
place). Its file name carries a hash of the source, the headers of
``csrc/`` and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. A failed build raises: nothing falls
back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile time of this process's build, 0 if loaded
    log: str            # nvcc's output (ptxas register/spill report)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _target(name: str):
    """(source, library): the library's name carries a hash of the source,
    of every header of csrc/ (a source may include any of them) and of the
    flags."""
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return source, build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library is up to date.
    Returns (source, library, process or None, temporary output, start)."""
    source, out = _target(name)
    if out.exists():
        return source, out, None, None, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f".{out.stem}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return source, out, proc, tmp, time.perf_counter()


def _finish(started) -> Built:
    source, out, proc, tmp, t0 = started
    seconds, log = 0.0, ""
    if proc is not None:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return Built(ctypes.CDLL(str(out)), out, seconds, log)


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (or reuse its up-to-date build) and load
    it."""
    return _finish(_start(name))


def build_many(names) -> dict:
    """``build`` for several sources with all their nvcc processes started
    together; returns {name: Built}. Every process ends before the first
    failed build raises. A library's ``seconds`` runs from its start to
    the moment its output was read, so it may include waiting for
    another."""
    started = {n: _start(n) for n in names}
    built, error = {}, None
    for n, s in started.items():
        try:
            built[n] = _finish(s)
        except RuntimeError as e:
            error = error or e
    if error is not None:
        raise error
    return built
