"""``chip_smoke.py`` holds the port's full-length main path on the card
against digests of the JAX package's final state (``REFERENCE_DIGESTS``,
the n_cores=8 / seed 0 cells of each fig1 sweep at 60,000 us).  This test
recomputes those digests with the JAX package, so the constants cannot
drift from the reference.  Eight cells per policy, a few MB of state."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import simlock as rsl

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("policy", sorted(cs.REFERENCE_DIGESTS))
def test_reference_digests_match_jax(policy):
    full = cs.MAIN_GRID[policy]
    axes = {k: [8] if k == "n_cores" else [0] if k == "seed" else v
            for k, v in full.items()}
    cfg = rsl.SimConfig(policy=policy, sim_time_us=cs.MAIN_US, epcap=8192,
                        **cs.FIG1)
    st, grid = rsl.sweep(cfg, axes)
    # The same cells, in the same order, as chip_smoke picks from the
    # full grid.
    import itertools
    cells = list(itertools.product(*full.values()))
    names = list(full)
    picked = [cells[i] for i in cs.reference_cells(
        {k: np.asarray([c[j] for c in cells]) for j, k in enumerate(names)})]
    assert [tuple(grid[k][i] for k in names) for i in
            range(len(picked))] == picked
    assert cs.state_digest(jax.tree.map(np.asarray, st)) == \
        cs.REFERENCE_DIGESTS[policy]


def test_plain_jobs_hold_every_comparison_once():
    """``chip_smoke.py`` runs its kernel-against-plain-step comparisons
    in a pool of processes: the job list holds each of phase 2's (the
    seven policies on fig1 and Bench-1, each with the gated features,
    the merged set, chunk 1 against 128), 3c's (the five load cuts, the
    features and the diurnal cut) and 3d's (the two keyed cuts, each
    ``ks_*`` policy with keys off on both programs) once, the long load
    cuts first.  Building the list runs nothing."""
    from repro_torch.core import simlock as sl
    from repro_torch.kernels import simstep
    names = [n for n, _ in cs.plain_jobs(sl, simstep)]
    assert len(names) == len(set(names)) == 38
    assert sum(n.startswith("2 ") for n in names) == 2 * 7 + 7 + 2
    assert [n for n in names if n.startswith("3c ")] == [
        "3c loadlat_sweep cut", "3c openloop_loadlat cut",
        "3c excess_tail cut", "3c chaos fifo cut", "3c chaos libasl cut",
        "3c features cut", "3c diurnal cut"]
    assert sum(n.startswith("3d ") for n in names) == 2 + 6
    assert names.index("3c loadlat_sweep cut") == 0


def test_card_time_is_none_without_a_complete_trace(monkeypatch, capsys):
    """A profile with fewer kernels and copies on the card than calls (on
    the CPU: none at all) gives no card time, after ``PROFILE_TRIES``
    traces: the card times in the kernels line are measured or null,
    never 0."""
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    assert cs.profiled(lambda: calls.append(1), 2) is None
    assert len(calls) == cs.PROFILE_TRIES * 2 * 2
    assert capsys.readouterr().out.count("holds 0 kernels") == \
        cs.PROFILE_TRIES
    wall, busy, idle = cs.device_busy(lambda: None, 2)
    assert wall >= 0 and busy is None and idle is None
    assert cs.kernel_split(lambda: None, 2) is None
    assert cs.fused_chunk_card_ms(lambda: None, 4) is None
    assert cs.card_text(None) == "not measured"
    assert cs.card_text(0.01234) == "0.0123"
