"""The kernel library's cache key: ``kernels/_cuda.py`` names the library
by a hash of the files in ``SOURCES`` and ``HEADERS``, so every CUDA file
under ``csrc/`` must be in one of them, or an edit to it would be served
from a stale library.  Nothing here compiles (the CPU has no nvcc)."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _cuda  # noqa: E402


def test_every_cuda_file_is_hashed():
    on_disk = {p.name for p in _cuda.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    listed = set(_cuda.SOURCES) | set(_cuda.HEADERS)
    assert on_disk == listed
    assert all(name.endswith(".cu") for name in _cuda.SOURCES)
    assert all(name.endswith(".cuh") for name in _cuda.HEADERS)


@pytest.mark.parametrize("name", _cuda.SOURCES + _cuda.HEADERS)
def test_an_edit_to_any_listed_file_renames_the_library(name, tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    before = _cuda.library_path()
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    assert _cuda.library_path() != before
