"""The kernels' build cache: a library is rebuilt when its source, a header
of ``csrc/`` or the compiler flags change, and reused otherwise. Only the
library's name is computed here; nothing is compiled (no ``nvcc`` on the
CPU)."""

from __future__ import annotations

import shutil

import pytest

from fedml_tpu_torch.core.kernels import build

pytestmark = pytest.mark.torch_port


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["flash_attention", "conv_block"])
def test_library_name_is_stable(csrc, name):
    assert build.library_path(name) == build.library_path(name)
    assert build.library_path(name).parent == build.BUILD_DIR


def test_header_edit_changes_the_library(csrc):
    """flash_attention.cu includes mma_tile.cuh: an edit to the header alone
    must name a new library, or a stale build would be loaded."""
    assert '#include "mma_tile.cuh"' in (csrc / "flash_attention.cu").read_text()
    before = build.library_path("flash_attention")
    header = csrc / "mma_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path("flash_attention") != before


def test_header_edit_changes_the_conv_block_library(csrc):
    """conv_block.cu includes mma_tile.cuh too (its bfloat16 kernel)."""
    assert '#include "mma_tile.cuh"' in (csrc / "conv_block.cu").read_text()
    before = build.library_path("conv_block")
    header = csrc / "mma_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path("conv_block") != before


@pytest.mark.parametrize("edit", ["source", "new_header", "flags"])
def test_other_inputs_change_the_library(csrc, monkeypatch, edit):
    before = build.library_path("flash_attention")
    if edit == "source":
        src = csrc / "flash_attention.cu"
        src.write_text(src.read_text() + "\n// edited\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("flash_attention") != before
