"""The JAX package's final states of ``chip_smoke.py``'s phase 3d, recomputed,
against the digests that script holds the card to: the keyshard figure's
four grids at full length (``FIGURE_DIGESTS``) and the keyed cuts
(``KEYSHARD_CUT_DIGESTS``); and the grids are ``paper_figs.keyshard``'s
own (the port's plain step on the cuts: ``test_torch_simlock_keyed_cuts.py``).
Tolerance: exact equality."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import simlock as rsl

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def jax_digest(grid) -> str:
    _, cfg, axes, slo, product = grid
    st, _ = rsl.sweep(cfg, axes, slo_us=slo, product=product)
    return cs.full_digest(jax.tree.map(np.asarray, st))


@pytest.mark.parametrize("name", [g[0] for g in cs.keyshard_grids(rsl)])
def test_keyshard_grid_digests_match_jax(name):
    grid = next(g for g in cs.keyshard_grids(rsl) if g[0] == name)
    assert jax_digest(grid) == cs.FIGURE_DIGESTS[name]


@pytest.mark.parametrize("name", sorted(cs.KEYSHARD_CUT_DIGESTS))
def test_keyed_cut_digests_match_jax(name):
    grid = next(g for g in cs.keyshard_cuts(rsl) if g[0] == name)
    assert jax_digest(grid) == cs.KEYSHARD_CUT_DIGESTS[name]


def test_keyshard_grids_follow_paper_figs():
    from benchmarks import paper_figs as pf
    assert cs.KEYSHARD_THETAS == pf.KEYSHARD_THETAS
    assert cs.KEYSHARD_LOCKS == pf.KEYSHARD_LOCKS
    assert cs.KEYSHARD_POLICIES == pf.KEYSHARD_POLICIES
    for (name, cfg, axes, slo, product), (pol, label) in zip(
            cs.keyshard_grids(rsl), pf.KEYSHARD_POLICIES):
        assert name == f"keyshard {label}" and not product and slo == 1e9
        assert cfg == pf._cfg(pol, 8, n_locks=cs.KEYSHARD_NLOCKS,
                              n_keys=cs.KEYSHARD_KEYS)
        assert len(axes["zipf_theta"]) == len(axes["n_locks"]) == 9
