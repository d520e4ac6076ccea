"""The port's kernel build keys each library by everything that goes into
it: ``build.lib_path`` changes when the source, a shared header
``csrc/*.cuh`` or the flags change, so a stale library is never loaded.
Runs on the CPU, with no ``nvcc``: it only computes paths."""

import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``build`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


# lib_path depends on the name only through the source and LIBS: one
# source that links the driver library and one that does not.
NAMES = ("simstep", "flash_attention")


@pytest.mark.parametrize("name", NAMES)
def test_lib_path_follows_every_header(csrc, name):
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the attention kernels share a header"
    before = build.lib_path(name)
    assert before == build.lib_path(name)
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    edited = build.lib_path(name)
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.lib_path(name) not in (before, edited)


@pytest.mark.parametrize("name", NAMES)
def test_lib_path_follows_the_source_and_the_flags(csrc, name, monkeypatch):
    before = build.lib_path(name)
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = build.lib_path(name)
    assert edited != before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.lib_path(name) != edited
    monkeypatch.setattr(build, "LIBS", {**build.LIBS, name: ("-lm",)})
    assert len({build.lib_path(name), edited, before}) == 3


def test_the_attention_sources_link_the_driver_library():
    for name in ("flash_attention", "flash_attention_bwd"):
        assert "-lcuda" in build.flags(name)
    assert "-lcuda" not in build.flags("simstep")
