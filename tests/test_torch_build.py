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


def test_variant_timer_reads_ptxas_registers_spills_and_warnings():
    from audioeditingcode_tpu_torch.ops import swiglu_ab

    log = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kv\n"
           "    0 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers, 448 bytes cmem[0]\n"
           "ptxas info    : Used 90 registers, used 1 barriers, 448 bytes cmem[0]\n"
           "ptxas warning : (C7510) a warning\n"
           "ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async instructions "
           "are serialized\n")
    got = swiglu_ab.ptxas_summary(log)
    assert (got["registers"], got["spill_stores"]) == (168, 24)
    assert got["warnings"] == log.splitlines()[-2:]
