"""The kernel build's bookkeeping, which runs without nvcc: every source
exists, and a library's name changes with its source and with the headers
it includes, so that an edit rebuilds, and with no other header."""

import os

import pytest

from audioeditingcode_tpu_torch.ops import build


@pytest.mark.parametrize("name", build.KERNEL_SOURCES)
def test_kernel_sources_exist(name):
    assert os.path.isfile(os.path.join(build.CSRC_DIR, name + ".cu"))


@pytest.mark.parametrize("edited", ["kernel.cu", "shared.cuh"])
def test_library_name_follows_source_and_headers(edited, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = build.library_path("kernel")
    assert build.library_path("kernel") == first
    (tmp_path / edited).write_text((tmp_path / edited).read_text() + "// v2\n")
    assert build.library_path("kernel") != first


def test_library_name_ignores_headers_not_included(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "plain.cu").write_text("#include <math.h>\n")
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = build.library_path("plain")
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert build.library_path("plain") == first


@pytest.mark.parametrize("name,headers", [("flash_attention", [b"tf32.cuh"]),
                                          ("swiglu", [b"hopper_tc.cuh", b"tf32.cuh"]),
                                          ("flash_attention_tc", [b"hopper_tc.cuh"]),
                                          ("swiglu_tc", [b"hopper_tc.cuh"])])
def test_kernel_sources_include_the_hashed_headers(name, headers):
    with open(os.path.join(build.CSRC_DIR, name + ".cu"), "rb") as f:
        assert build._LOCAL_INCLUDE.findall(f.read()) == headers
