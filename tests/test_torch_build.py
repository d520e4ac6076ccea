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


# fused_chunk's 31 instantiations (csrc/simstep.cu, launch_args): each
# policy's deterministic one on Args (the ks_* policies' on ArgsK), the
# merged set's on both; each stochastic one on both (ks_*: ArgsK only).
INSTANTIATIONS = {(p, st, k) for p in range(11) for st in (False, True)
                  for k in (False, True)
                  if not (p in (7, 8, 9) and not k)
                  and not (not st and p < 7 and k)}


def test_simstep_groups_hold_every_instantiation_once():
    groups = build.SIMSTEP_GROUPS
    flat = [i for g in groups for i in g]
    assert len(INSTANTIATIONS) == 31
    assert sorted(flat) == sorted(INSTANTIATIONS)
    assert build.parts("simstep") == len(groups) > 1
    assert build.parts("flash_attention") == 1
    masks = [int(build.flags("simstep", g)[-1].split("=")[1][:-3], 16)
             for g in range(len(groups))]
    assert sum(masks) == sum(1 << (4 * p + 2 * st + k)
                             for p, st, k in INSTANTIATIONS)
    assert len({build.lib_path("simstep", g) for g in range(len(groups))}) \
        == len(groups)
    assert [build.unit("simstep", g) for g in (0, 1)] == \
        ["simstep.0", "simstep.1"]
    assert build.unit("mlstm_scan", 0) == "mlstm_scan"


@pytest.mark.parametrize("kw", [
    dict(policy="libasl"), dict(policy_set=("fifo", "libasl")),
    dict(policy_set=("fifo", "ks_crew")), dict(policy="ks_jbsq"),
    dict(policy="tas", wl=True), dict(policy="edf", hist=True),
    dict(policy="fifo", n_keys=64, n_locks=4),
    dict(policy="ks_erew", preempt_rate=0.1),
    dict(policy_set=("fifo", "libasl"), wl=True),
    dict(policy_set=("fifo", "ks_crew"), wl=True)])
def test_a_launch_loads_the_library_of_its_instantiation(kw):
    from repro_torch.core import simlock as sl
    from repro_torch.kernels import simstep
    cfg = sl.SimConfig(**kw)
    p = simstep.instantiation(cfg)
    inst = (10 if p == -1 else p, simstep.stochastic(cfg),
            simstep.keyed(cfg))
    assert inst in INSTANTIATIONS
    assert inst in build.SIMSTEP_GROUPS[simstep.part(cfg)]
