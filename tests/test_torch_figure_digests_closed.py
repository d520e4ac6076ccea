"""The JAX package's final states of ``chip_smoke.py``'s phase 3e fig1
grids (``fig1_collapse`` for the registered policies phase 3b does not
run), full length, recomputed, against the digests that script holds the
card to (``FIGURE_DIGESTS``; the other closed-loop figures and phase 3f's
grids in ``test_torch_figure_digests_closed2.py``).  Tolerance: exact
equality."""

import jax
import numpy as np
import pytest

from repro.core import simlock as rsl
from test_torch_simstep_figs import cs


def sweep_digest(name, cfg, axes, slo, product) -> str:
    st, _ = rsl.sweep(cfg, axes, slo_us=slo, product=product)
    return cs.full_digest(jax.tree.map(np.asarray, st))


@pytest.mark.parametrize("policy", cs.FIG1_MORE)
def test_fig1_digests_match_jax(policy):
    grid = next(g for g in cs.closed_grids(rsl)
                if g[0] == f"collapse {policy}")
    assert sweep_digest(*grid) == cs.FIGURE_DIGESTS[grid[0]]


def test_every_registered_policy_has_a_fig1_grid():
    """fig1_collapse runs every registered policy: 3e's seven and 3b's
    edf, shfl and dvfs_race."""
    from repro.core.policies import REGISTRY
    held = set(cs.FIG1_MORE) | {"edf", "shfl", "dvfs_race"}
    assert held == set(REGISTRY)
    assert all(f"collapse {p}" in cs.FIGURE_DIGESTS for p in cs.FIG1_MORE)
    assert all(f"fig1 {p}" in cs.FIGURE_DIGESTS
               for p in ("edf", "shfl", "dvfs_race"))
