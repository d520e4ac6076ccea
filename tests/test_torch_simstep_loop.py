"""The simulator's host loop (``core/simlock.py::simulate``,
``run_chunks``) and the kernel wrapper's one-time operand check
(``kernels/simstep.py::bind``), on CPU tensors with the plain chunk.

On CUDA tensors ``simulate`` checks for live cells once per
``LIVENESS_GROUP`` kernel launches instead of after each one; here the
same loop is driven with a counting plain ``chunk_fn`` and must give
every ``SimState`` leaf identical to checking after every chunk, since a
chunk after a cell's end changes nothing, and identical to the JAX
package's ``sweep`` of the same cells.  Golden-digest scale
(``SIM_US=4000``, ``SLO_US=80``, ``SEED=3``).  Tolerance: exact
equality."""

import dataclasses

import pytest
import torch

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from repro_torch.kernels import simstep

# Cells that end at different chunks: 4 and 8 cores, two seeds.
AXES = {"n_cores": [4, 8], "seed": [gd.SEED, gd.SEED + 1]}


def _start(policy):
    cfg = sl.SimConfig(policy=policy, sim_time_us=gd.SIM_US)
    tb, pm, st, _ = sl.init_sweep(cfg, AXES, slo_us=gd.SLO_US,
                                  seed=gd.SEED, device="cpu")
    return cfg, tb, pm, st


def _clone(st):
    return type(st)(**{k: v if k == "pol" else v.clone()
                       for k, v in st._asdict().items()})


def _assert_same(a, b):
    for k in a._fields:
        if k != "pol":
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def _counting_chunk(cfg, tb, pm, st):
    calls = []

    def launch():
        calls.append(1)
        simstep.fused_chunk_ref(tb, pm, st, cfg.chunk, cfg)

    return launch, calls


@pytest.mark.parametrize("policy", ["fifo", "libasl"])
def test_grouped_liveness_checks_give_identical_leaves(policy):
    cfg, tb, pm, st = _start(policy)
    grouped = _clone(st)
    launch, calls = _counting_chunk(cfg, tb, pm, st)
    n_one = sl.run_chunks(cfg, pm, st, launch, 1)
    assert n_one == len(calls) >= 2
    launch, calls = _counting_chunk(cfg, tb, pm, grouped)
    n_group = sl.run_chunks(cfg, pm, grouped, launch, sl.LIVENESS_GROUP)
    assert n_group == len(calls)
    assert n_group % sl.LIVENESS_GROUP == 0
    assert n_one <= n_group < n_one + sl.LIVENESS_GROUP
    _assert_same(grouped, st)
    # Checking after every chunk stops at the last live one: the most
    # chunks any cell needed (chip_smoke.py counts the launches past the
    # end from this).
    need = int(((st.events + cfg.chunk - 1) // cfg.chunk).max())
    assert n_one == need
    assert not bool(sl._live_cells(cfg, pm, st).any())


@pytest.mark.parametrize("policy", ["fifo", "tas", "prop", "libasl"])
def test_grouped_liveness_checks_match_the_reference(policy):
    """The grouped loop's final state, launches past the end included,
    equals the JAX package's ``sweep`` (its liveness checked on the
    device in ``lax.while_loop``) leaf for leaf."""
    cfg, tb, pm, st = _start(policy)
    launch, calls = _counting_chunk(cfg, tb, pm, st)
    n = sl.run_chunks(cfg, pm, st, launch, sl.LIVENESS_GROUP)
    need = int(((st.events + cfg.chunk - 1) // cfg.chunk).max())
    assert n == len(calls) > need
    rst, _ = rsl.sweep(rsl.SimConfig(policy=policy, sim_time_us=gd.SIM_US),
                       AXES, slo_us=gd.SLO_US, seed=gd.SEED)
    got, want = gd.digest_state(sl.to_reference(st)), gd.digest_state(rst)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


def test_chunks_after_the_end_change_no_leaf():
    cfg, tb, pm, st = _start("tas")
    sl.simulate(cfg, tb, pm, st)
    done = _clone(st)
    for chunk in (1, cfg.chunk, cfg.chunk):
        simstep.fused_chunk(tb, pm, st, chunk, cfg)
    _assert_same(st, done)


def test_simulate_checks_the_operands_once(monkeypatch):
    cfg, tb, pm, st = _start("prop")
    checks, chunks = [], []
    operands, chunk_ref = simstep._operands, simstep.fused_chunk_ref

    def count_operands(*args):
        checks.append(1)
        return operands(*args)

    def count_chunk(*args):
        chunks.append(1)
        return chunk_ref(*args)

    monkeypatch.setattr(simstep, "_operands", count_operands)
    monkeypatch.setattr(simstep, "fused_chunk_ref", count_chunk)
    sl.simulate(cfg, tb, pm, st)
    assert len(checks) == 1 and len(chunks) >= 2
    # The public wrapper checks every call.
    simstep.fused_chunk(tb, pm, st, 1, cfg)
    simstep.fused_chunk(tb, pm, st, 1, cfg)
    assert len(checks) == 3


@pytest.mark.parametrize("leaf,bad,err,match", [
    ("window", lambda x: x.double(), TypeError, "window"),
    ("phase", lambda x: x.long(), TypeError, "phase"),
    ("holder", lambda x: x[:, :0], ValueError, "shape"),
    ("q_tail", lambda x: x[:, :, :1], ValueError, "shape"),
])
def test_operands_checked_once_still_raise_before_the_first_launch(
        leaf, bad, err, match, monkeypatch):
    cfg, tb, pm, st = _start("libasl")
    st = st._replace(**{leaf: bad(getattr(st, leaf))})
    chunks = []
    monkeypatch.setattr(simstep, "fused_chunk_ref",
                        lambda *args: chunks.append(1))
    with pytest.raises(err, match=match):
        sl.simulate(cfg, tb, pm, st)
    with pytest.raises(err, match=match):
        simstep.bind(tb, pm, st, cfg.chunk, cfg)
    with pytest.raises(err, match=match):
        simstep.fused_chunk(tb, pm, st, cfg.chunk, cfg)
    assert not chunks


def test_simulate_with_a_chunk_fn_checks_after_every_chunk():
    """A given ``chunk_fn`` runs as many chunks as the cells need: one
    liveness check after each."""
    cfg, tb, pm, st = _start("fifo")
    cfg = dataclasses.replace(cfg, chunk=64)
    calls = []

    def chunk_fn(*args):
        calls.append(1)
        simstep.fused_chunk_ref(*args)

    sl.simulate(cfg, tb, pm, st, chunk_fn=chunk_fn)
    assert len(calls) == int(((st.events + 63) // 64).max())
