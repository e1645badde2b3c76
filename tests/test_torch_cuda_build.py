"""``repro_torch.kernels.cuda_build`` tags a kernel library by its source,
every header the source includes from the port's ``csrc`` directories,
and the flags. These tests need no ``nvcc``: they edit files in a
temporary directory and watch the tag."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd  # noqa: E402


@pytest.fixture
def tree(tmp_path):
    """k.cu includes "local.cuh" (beside it), which includes "shared.cuh"
    (in the shared include directory); other.cuh is included by nothing."""
    src_dir, inc_dir = tmp_path / "csrc", tmp_path / "include"
    src_dir.mkdir()
    inc_dir.mkdir()
    (src_dir / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "local.cuh"\n'
        "__global__ void k() {}\n")
    (src_dir / "local.cuh").write_text('#pragma once\n  #  include "shared.cuh"\n')
    (inc_dir / "shared.cuh").write_text("#pragma once\n// helpers\n")
    (inc_dir / "other.cuh").write_text("#pragma once\n")
    return src_dir / "k.cu", inc_dir


def _tag(source, inc_dir):
    return cuda_build.tag(source, include_dirs=[inc_dir])


def test_includes_follow_quoted_headers_only(tree):
    source, inc_dir = tree
    names = [p.name for p in cuda_build.includes(source, [inc_dir])]
    assert names == ["local.cuh", "shared.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "local.cuh", "shared.cuh"])
def test_editing_the_source_or_an_included_header_changes_the_tag(tree, edited):
    source, inc_dir = tree
    before = _tag(source, inc_dir)
    path = (inc_dir if edited == "shared.cuh" else source.parent) / edited
    path.write_text(path.read_text() + "// edited\n")
    assert _tag(source, inc_dir) != before


def test_editing_an_unrelated_file_keeps_the_tag(tree):
    source, inc_dir = tree
    before = _tag(source, inc_dir)
    (inc_dir / "other.cuh").write_text("#pragma once\n// edited\n")
    (source.parent / "notes.txt").write_text("unrelated\n")
    assert _tag(source, inc_dir) == before


def test_the_flags_enter_the_tag(tree):
    source, inc_dir = tree
    assert (cuda_build.tag(source, [inc_dir], flags=("-O3",))
            != cuda_build.tag(source, [inc_dir], flags=("-O2",)))


@pytest.mark.parametrize("source", [flash.SOURCE, flash.BWD_SOURCE, ssd.SOURCE,
                                    ssd.BWD_SOURCE],
                         ids=["flash", "flash_bwd", "ssd", "ssd_bwd"])
def test_port_kernels_include_the_shared_header(source):
    """Every kernel source includes hopper.cuh from the shared directory,
    which nvcc is told about and whose content is in the library's tag."""
    shared = cuda_build.INCLUDE_DIR / "hopper.cuh"
    assert shared.is_file()
    assert shared.resolve() in cuda_build.includes(source)
    flags = cuda_build.NVCC_FLAGS
    assert flags[flags.index("-I") + 1] == str(cuda_build.INCLUDE_DIR)


def test_the_shared_state_header_is_in_both_ssd_libraries_tags(tmp_path):
    """The chunk-state product and the recurrence live once, in
    ssd_states.cuh beside the two SSD sources, and enter both libraries'
    tags: an edit there rebuilds the forward and the backward."""
    header = ssd.SOURCE.parent / "ssd_states.cuh"
    for source in (ssd.SOURCE, ssd.BWD_SOURCE):
        assert header.resolve() in cuda_build.includes(source)
    for path in (ssd.SOURCE, ssd.BWD_SOURCE, header):
        (tmp_path / path.name).write_text(path.read_text())
    copies = [tmp_path / ssd.SOURCE.name, tmp_path / ssd.BWD_SOURCE.name]
    before = [cuda_build.tag(c) for c in copies]
    (tmp_path / header.name).write_text(header.read_text() + "// edited\n")
    after = [cuda_build.tag(c) for c in copies]
    assert all(b != a for b, a in zip(before, after))
