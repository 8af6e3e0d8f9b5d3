"""The port's kernel build (``repro_torch.kernels._build``), on the CPU: a
library is keyed by its source, every header the source includes from
``csrc/`` and the flags, so an edited header rebuilds every source that
includes it and nothing else. No nvcc runs here.

  PYTHONPATH=src python -m pytest -q tests/test_torch_build.py
"""
import shutil

from repro_torch.kernels import _build


def test_a_header_edit_changes_the_target_of_every_source_including_it(
        tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert [p.name for p in _build._sources("ssd", csrc)] == [
        "ssd.cu", "hopper.cuh"]
    assert [p.name for p in _build._sources("gram", csrc)] == ["gram.cu"]
    before = {stem: _build._target(stem, csrc) for stem in _build.SOURCES}
    assert before == {stem: _build._target(stem) for stem in _build.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {stem: _build._target(stem, csrc) for stem in _build.SOURCES}
    for stem in _build.SOURCES:
        includes = stem in ("ssd", "flash_attention", "prox_step")
        assert (after[stem] != before[stem]) == includes, stem
        assert after[stem].name.startswith(f"{stem}-")


def test_headers_are_followed_through_other_headers_once(tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n#include <cuda.h>\n')
    (tmp_path / "b.cuh").write_text('  #  include "a.cuh"\n')
    assert [p.name for p in _build._sources("k", tmp_path)] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = _build._target("k", tmp_path)
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n// b\n')
    assert _build._target("k", tmp_path) != before
