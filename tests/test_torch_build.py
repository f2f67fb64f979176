"""The kernel build's cache key: a library is named by the hash of its
source, every shared ``csrc/*.cuh`` header and the flags, so editing a
header rebuilds each library that may include it.  Needs no nvcc."""

import shutil

import pytest

from partitionedhashjoin_tpu_torch.ops.kernels import _build

LIBRARIES = ("compact", "radix_sort", "bitonic_sort")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_sources_include_the_shared_header():
    assert (_build.CSRC_DIR / "lookback.cuh").is_file()
    for name in ("compact", "radix_sort"):
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "lookback.cuh"' in text


@pytest.mark.parametrize("name", LIBRARIES)
def test_editing_a_header_changes_the_library_path(csrc, name):
    before = _build.library_path(name)
    assert before == _build.library_path(name)  # stable
    assert before.parent == _build.BUILD_DIR and before.name.startswith(name + "-")
    header = csrc / "lookback.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before
    header.write_text(header.read_text().replace("\n// edited\n", ""))
    assert _build.library_path(name) == before


def test_new_header_and_source_edit_change_the_path(csrc):
    before = _build.library_path("compact")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = _build.library_path("compact")
    assert with_header != before
    source = csrc / "compact.cu"
    source.write_text(source.read_text() + "\n")
    assert _build.library_path("compact") not in (before, with_header)
    # another library's source does not move this one
    radix = _build.library_path("radix_sort")
    other = csrc / "merge_count.cu"
    other.write_text(other.read_text() + "\n")
    assert _build.library_path("radix_sort") == radix
