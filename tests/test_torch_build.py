"""The port's kernel build helper (``kernels/_build.py``) on the CPU.

A library is named by a hash of its source, of the shared headers beside it
(``csrc/*.cuh``) and of the nvcc flags, so that an edited header rebuilds
every kernel instead of loading a stale library. Nothing is compiled here.
"""
import re

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "h.cuh"\n__global__ void k() {}\n')
    (d / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", d)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return d


@pytest.mark.parametrize("edit", [
    lambda d: (d / "h.cuh").write_text("// two\n"),          # a header's bytes
    lambda d: (d / "other.cuh").write_text("// new\n"),      # a new header
    lambda d: (d / "k.cu").write_text("// edited\n"),        # the source
], ids=["header_bytes", "new_header", "source"])
def test_lib_path_changes_with_the_source_and_headers(csrc, edit):
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    edit(csrc)
    assert _build.lib_path("k") != first


def test_lib_path_ignores_files_that_are_not_headers(csrc):
    first = _build.lib_path("k")
    (csrc / "notes.txt").write_text("x\n")
    (csrc / "other.cu").write_text("// another kernel\n")
    assert _build.lib_path("k") == first


def test_every_included_header_lies_in_csrc():
    """Each ``#include "..."`` of the port's sources names a ``*.cuh`` in
    ``csrc/``, so that lib_path hashes it."""
    names = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "tf32x3.cuh" in names
    users = set()
    for src in _build.CSRC.glob("*.cu*"):
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert inc in names, f"{src.name} includes {inc}"
            users.add(src.stem)
    assert {"grouped_matmul", "flash_attention", "slstm_scan"} <= users
