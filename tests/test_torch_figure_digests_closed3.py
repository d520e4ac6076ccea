"""The JAX package's final states of ``chip_smoke.py``'s phase 3e
``bench2_variable`` (four runs, the windows carried) and phase 3f's
Figure 8b through ``sweep_slo`` and ``amp_config`` multi-tenant grid,
full length, recomputed, against the digests that script holds the card
to (``FIGURE_DIGESTS``; the other grids in
``test_torch_figure_digests_closed*.py``).  Tolerance: exact equality."""

import jax
import numpy as np

from repro.core import simlock as rsl
from repro.workloads import clients as jc
from repro.workloads import generators as jg
from test_torch_figure_digests_closed import sweep_digest
from test_torch_simstep_figs import cs


def test_bench2_carried_runs_match_jax():
    windows = None
    for name, cfg in cs.bench2_phases(rsl):
        st = rsl.run(cfg, cs.BENCH2_SLO, 0, windows)
        assert cs.full_digest(jax.tree.map(np.asarray, st)) == \
            cs.FIGURE_DIGESTS[name], name
        windows = np.asarray(st.window).copy()


def test_sweep_slo_and_amp_grid_match_jax():
    st = rsl.sweep_slo(cs.fig8b_cfg(rsl), list(cs.FIG8B_SLOS))
    assert cs.full_digest(jax.tree.map(np.asarray, st)) == \
        cs.FIGURE_DIGESTS["figure8b sweep_slo"]
    grid = cs.amp_grid(rsl, jc, jg)
    assert grid[1].slo_scale == (1.0,) * 4 + (10.0,) * 4
    assert sweep_digest(*grid) == cs.FIGURE_DIGESTS[grid[0]]
