"""The JAX package's final states of ``chip_smoke.py``'s phase 3e and 3f
grids, full length, recomputed, against the digests that script holds
the card to (``FIGURE_DIGESTS``): ``fig4_big_affinity``,
``fig5_proportional``, ``bench1_slo_sweep`` and ``bench4_scalability``
(its libasl grid from its tas rows' P99s); fig1 in
``test_torch_figure_digests_closed.py``, Bench-2, Figure 8b and the
``amp_config`` grid in ``test_torch_figure_digests_closed3.py``.
Tolerance: exact equality."""

import functools

import jax
import numpy as np
import pytest

from repro.core import simlock as rsl
from test_torch_figure_digests_closed import sweep_digest
from test_torch_simstep_figs import cs

GRIDS = [g[0] for g in cs.closed_grids(rsl)
         if not g[0].startswith("collapse")]


@pytest.mark.parametrize("name", [n for n in GRIDS if n != "bench4 tas"])
def test_closed_grid_digests_match_jax(name):
    grid = next(g for g in cs.closed_grids(rsl) if g[0] == name)
    assert sweep_digest(*grid) == cs.FIGURE_DIGESTS[name]


@functools.lru_cache(maxsize=None)
def _bench4_tas():
    _, cfg, axes, slo, product = next(
        g for g in cs.closed_grids(rsl) if g[0] == "bench4 tas")
    st, grid = rsl.sweep(cfg, axes, slo_us=slo, product=product)
    p99 = [s["ep_p99_all_us"]
           for s in rsl.sweep_summaries(cfg, st, grid, slo_us=slo)]
    return cs.full_digest(jax.tree.map(np.asarray, st)), p99


def test_bench4_digests_match_jax():
    """The tas grid, then the zipped libasl grid its P99s set (24
    cells: SLO 0, the tas P99, LibASL-MAX at each n)."""
    digest, p99 = _bench4_tas()
    assert digest == cs.FIGURE_DIGESTS["bench4 tas"]
    grid = cs.bench4_phase2(rsl, p99)
    assert len(grid[2]["n_cores"]) == 24
    assert sweep_digest(*grid) == cs.FIGURE_DIGESTS["bench4 libasl"]
