"""The kernel libraries' names follow what they are built from: every
source of csrc/ and every header it may include (``kernels/_build.py``
``_target``), so that an edited header rebuilds the libraries instead of
loading a stale one. Run against a temporary copy of ``csrc/``; needs no
nvcc."""
import shutil

import pytest

from repro_torch.kernels import _build

# the sources that include the shared 3xTF32 header
TF32X3_USERS = ("flash_attention", "decode_attention")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return copy


def _names():
    return {n: _build._target(n)[1].name
            for n in ("channel_ring", "rmsnorm", "flash_attention",
                      "ssm_scan", "decode_attention")}


def test_the_3xtf32_header_is_included_by_both_float32_kernels(csrc):
    for name in TF32X3_USERS:
        assert '#include "tf32x3.cuh"' in (csrc / f"{name}.cu").read_text()


@pytest.mark.parametrize("edit", ["header", "source", "new header"])
def test_editing_a_header_or_source_renames_the_library(csrc, edit):
    before = _names()
    assert _names() == before                   # the same files, one name
    if edit == "header":
        with open(csrc / "tf32x3.cuh", "a") as f:
            f.write("\n// edited\n")
        changed = set(before)                   # any source may include it
    elif edit == "source":
        with open(csrc / "decode_attention.cu", "a") as f:
            f.write("\n// edited\n")
        changed = {"decode_attention"}
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
        changed = set(before)
    after = _names()
    for name in before:
        assert (after[name] != before[name]) == (name in changed), name
        assert after[name].startswith(f"{name}-")
        assert after[name].endswith(".so")
