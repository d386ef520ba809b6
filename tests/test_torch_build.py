"""The kernel build's cache key, on the CPU (no nvcc needed): the build
directory is keyed by every ``csrc/*.cu`` source and every ``csrc/*.cuh``
header they share, so editing, adding or renaming any of them rebuilds, and
an unchanged tree reuses its build."""

import shutil

import pytest

from vettore_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


def test_every_kernel_source_is_built():
    names = [p.name for p in _build.sources()]
    assert names == sorted(names)
    assert {"flat_scan.cu", "adaptive_scan.cu", "int8_scan.cu", "maxsim.cu"} <= set(names)
    assert [p.name for p in _build.headers()] == ["group_rescore.cuh", "wgmma_scan.cuh"]


def test_key_is_stable_for_the_same_sources(csrc):
    assert _build.build_dir(csrc) == _build.build_dir(csrc) == _build.build_dir()
    assert len(_build.build_dir(csrc).name) == 16


@pytest.mark.parametrize("source", ["flat_scan.cu", "adaptive_scan.cu", "int8_scan.cu",
                                    "maxsim.cu", "group_rescore.cuh", "wgmma_scan.cuh"])
def test_key_changes_when_any_source_changes(csrc, source):
    before = _build.build_dir(csrc)
    path = csrc / source
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build.build_dir(csrc) != before


@pytest.mark.parametrize("change", ["add", "add header", "remove", "rename"])
def test_key_changes_with_the_set_of_sources(csrc, change):
    before = _build.build_dir(csrc)
    if change == "add":
        (csrc / "extra.cu").write_text("// another kernel\n")
    elif change == "add header":
        (csrc / "extra.cuh").write_text("// another shared header\n")
    elif change == "remove":
        (csrc / "adaptive_scan.cu").unlink()
    else:
        (csrc / "adaptive_scan.cu").rename(csrc / "stage_scan.cu")
    assert _build.build_dir(csrc) != before
