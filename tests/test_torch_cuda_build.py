"""The CUDA build's cache key (``repro_torch/kernels/_cuda_build.py``),
on the CPU: a library is keyed by its source, every shared header
``csrc/*.cuh``, the ``nvcc`` version and the flags, so that an edited
header such as ``sm90.cuh`` never loads a stale library. ``nvcc`` is not
needed: its version is monkeypatched."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _cuda_build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead, and a fixed nvcc."""
    copy = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC, copy)
    monkeypatch.setattr(_cuda_build, "CSRC", copy)
    monkeypatch.setattr(_cuda_build, "_nvcc_version",
                        lambda nvcc: "nvcc: release 12.9")
    return copy


@pytest.mark.parametrize("name", _cuda_build.SOURCES)
def test_key_changes_with_a_header(csrc, name):
    assert (csrc / "sm90.cuh").exists()
    before = _cuda_build.library_path(name, "nvcc")
    assert before == _cuda_build.library_path(name, "nvcc")
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _cuda_build.library_path(name, "nvcc")
    assert after != before and after.name.startswith(f"{name}-")
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _cuda_build.library_path(name, "nvcc") not in (before, after)


def test_key_changes_with_source_flags_and_nvcc(csrc, monkeypatch):
    base = _cuda_build.library_path("ssd_scan", "nvcc")
    with open(csrc / "ssd_scan.cu", "a") as f:
        f.write("\n// edited\n")
    edited = _cuda_build.library_path("ssd_scan", "nvcc")
    monkeypatch.setattr(_cuda_build, "NVCC_FLAGS",
                        _cuda_build.NVCC_FLAGS + ("-I", "/usr/include"))
    flagged = _cuda_build.library_path("ssd_scan", "nvcc")
    monkeypatch.setattr(_cuda_build, "_nvcc_version",
                        lambda nvcc: "nvcc: release 13.0")
    other = _cuda_build.library_path("ssd_scan", "nvcc")
    assert len({base, edited, flagged, other}) == 4
    # the other kernel's key does not depend on this source
    assert _cuda_build.library_path("flash_attention", "nvcc") == \
        _cuda_build.library_path("flash_attention", "nvcc")
