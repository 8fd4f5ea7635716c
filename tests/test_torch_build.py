"""The kernel build's library name: its hash covers the source and every
header the source includes by a quoted name from ``csrc/`` (recursively),
so an edited header never loads a stale library. No compiler is needed:
only the name is computed."""
import pytest

from quip_tpu_torch.kernels import _build


def _tree(tmp_path):
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "common.cuh"\nint k;\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\nint inner;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")


@pytest.mark.parametrize("edited,changes", [
    ("k.cu", True), ("common.cuh", True), ("inner.cuh", True),
    ("other.cuh", False)])
def test_edited_header_changes_the_hash(tmp_path, monkeypatch, edited,
                                        changes):
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    _tree(tmp_path)
    assert [f.name for f in _build._sources("k")] == [
        "k.cu", "common.cuh", "inner.cuh"]
    before = _build._target("k")
    with open(tmp_path / edited, "a") as f:
        f.write("// edited\n")
    assert (_build._target("k") != before) == changes
    assert _build._target("k").name.startswith("libk-")


def test_every_kernel_source_hashes():
    """The port's own sources: each names its library, and none includes a
    quoted header that is missing from ``csrc/``."""
    for src in sorted(_build._CSRC.glob("*.cu")):
        files = _build._sources(src.stem)
        assert files[0] == src
        for inc in _build._INCLUDE.findall(src.read_text()):
            assert (src.parent / inc).is_file(), (src.name, inc)
        assert _build._target(src.stem).suffix == ".so"
