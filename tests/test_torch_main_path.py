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
