"""The port's resumable sweep (``sweep(resume_dir=, resume_chunk=)``):
cells run in ``resume_chunk``-cell slices, each saved when it finishes;
a run whose last slices' checkpoints are deleted (an interrupted run)
resumes from the rest.  The one-shot sweep, the resumable sweep and the
resumed sweep against each other and against the JAX package's sweep,
leaf for leaf, over chunks of 1, 3 and 8 on a merged grid (here, at the
golden-digest scale) and a stochastic grid
(``test_torch_simlock_resume_stoch.py``); and the refusals of a
directory that holds another sweep, one the JAX package wrote included.
Tolerance: exact equality."""

import functools
import json
import shutil

import pytest

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.ckpt import checkpointer as ckpt
from repro_torch.core import simlock as sl

FIG1 = dict(n_cores=8, big=(1,) * 4 + (0,) * 4,
            speed_cs=(1.0,) * 4 + (3.75,) * 4,
            speed_nc=(1.0,) * 4 + (1.8,) * 4, seg_noncrit_us=(1.0,),
            seg_cs_us=(3.0,), seg_lock=(0,), inter_epoch_us=5.0)
# A merged fifo / libasl set, four cells (chunks of 3 leave one of 1).
MERGED = (dict(FIG1, policy="fifo", sim_time_us=gd.SIM_US),
          {"policy": ["fifo", "libasl", "fifo", "libasl"],
           "slo_us": [1e9, gd.SLO_US, 1e9, 60.0], "seed": [0, 1, 2, 3],
           "n_cores": [8, 8, 8, 7]})


@functools.lru_cache(maxsize=None)
def reference(kw: tuple, axes: tuple) -> dict:
    """Digests of the JAX package's sweep of the grid."""
    rst, _ = rsl.sweep(rsl.SimConfig(**dict(kw)), _axes(axes),
                       slo_us=gd.SLO_US, product=False)
    return gd.digest_state(rst)


@functools.lru_cache(maxsize=None)
def one_shot(kw: tuple, axes: tuple) -> dict:
    st, _ = sl.sweep(sl.SimConfig(**dict(kw)), _axes(axes),
                     slo_us=gd.SLO_US, product=False, device="cpu")
    return gd.digest_state(sl.to_reference(st))


def _axes(axes: tuple) -> dict:
    return {k: list(v) for k, v in axes}


def _key(grid) -> tuple:
    kw, axes = grid
    return tuple(sorted(kw.items())), tuple((k, tuple(v))
                                            for k, v in axes.items())


def check_resume(grid, chunk, tmp_path) -> None:
    """One-shot == JAX; a resumable run == one-shot; its last slice's
    checkpoint deleted, the resumed run == one-shot, and it ran only
    that slice."""
    kw, axes = _key(grid)
    assert one_shot(kw, axes) == reference(kw, axes)
    cfg = sl.SimConfig(**grid[0])
    n_slices = -(-len(grid[1]["seed"]) // chunk)

    def resumable():
        n0 = len(sl.sweep_log())
        st, _ = sl.sweep(cfg, grid[1], slo_us=gd.SLO_US, product=False,
                         device="cpu", resume_dir=tmp_path,
                         resume_chunk=chunk)
        return gd.digest_state(sl.to_reference(st)), sl.sweep_log()[n0:]

    got, log = resumable()
    assert got == one_shot(kw, axes)
    assert [r["n_cells"] for r in log] == \
        [min(chunk, len(grid[1]["seed"]) - k * chunk)
         for k in range(n_slices)]
    assert ckpt.latest_step(tmp_path) == n_slices - 1
    shutil.rmtree(tmp_path / f"step_{n_slices - 1}")
    got, log = resumable()
    assert got == one_shot(kw, axes)
    assert len(log) == 1 and ckpt.latest_step(tmp_path) == n_slices - 1


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_merged_grid_resumes_bit_identical(chunk, tmp_path):
    check_resume(MERGED, chunk, tmp_path)


def test_resume_refuses_another_sweep(tmp_path):
    cfg = sl.SimConfig(policy="tas", sim_time_us=200.0)
    axes = {"seed": [0, 1, 2], "w_big": [0.5, 1.0, 2.0]}
    sl.sweep(cfg, axes, product=False, device="cpu", resume_dir=tmp_path,
             resume_chunk=2)
    fp = json.loads((tmp_path / "sweep.json").read_text())
    assert fp["n_cells"] == 3 and fp["chunk"] == 2
    text = (f"resume_dir {str(tmp_path)!r} holds a different sweep "
            f"(config or grid changed); use a fresh directory")
    for other in (
            dict(axes=dict(axes, w_big=[0.5, 1.0, 4.0])),       # a value
            dict(axes=axes, resume_chunk=3),                     # the chunk
            dict(axes=dict(axes, seed=[0, 1, 2, 3],
                           w_big=[0.5, 1.0, 2.0, 2.0])),         # the cells
            dict(axes=axes, cfg=sl.SimConfig(policy="tas",
                                             sim_time_us=300.0))):
        kw = {"resume_chunk": 2, **other}
        with pytest.raises(ValueError) as e:
            sl.sweep(kw.pop("cfg", cfg), kw.pop("axes"), product=False,
                     device="cpu", resume_dir=tmp_path, **kw)
        assert str(e.value) == text
    # The same sweep still resumes: every slice restored, none run.
    n0 = len(sl.sweep_log())
    sl.sweep(cfg, axes, product=False, device="cpu", resume_dir=tmp_path,
             resume_chunk=2)
    assert len(sl.sweep_log()) == n0


def test_resume_refuses_a_jax_written_directory(tmp_path):
    """The JAX package's resumable sweep of the same grid writes leaves
    of other dtypes (``key`` u32 there, i64 here): refused, not
    spliced."""
    axes = {"seed": [0, 1, 2], "w_big": [0.5, 1.0, 2.0]}
    rsl.sweep(rsl.SimConfig(policy="tas", sim_time_us=200.0), axes,
              product=False, resume_dir=tmp_path, resume_chunk=2)
    with pytest.raises(ValueError) as e:
        sl.sweep(sl.SimConfig(policy="tas", sim_time_us=200.0), axes,
                 product=False, device="cpu", resume_dir=tmp_path,
                 resume_chunk=2)
    assert "holds a different sweep" in str(e.value)
