"""The JAX package's final states of the load-figure cuts that
``chip_smoke.py``'s phase 3c holds the card's kernel to (``cut_grid`` of
``loadlat_sweep``, ``openloop_loadlat``, ``excess_tail`` and
``chaos_collapse`` on fifo and libasl; 4,000 us each), recomputed,
against its ``CUT_DIGESTS``.  The features cut is in
``test_torch_figure_digests_features.py``; the full-length load grids'
digests (``FIGURE_DIGESTS``) were recorded once from the JAX package.
Tolerance: exact equality."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import simlock as rsl

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def cut_digest(name: str) -> str:
    cut = next(c for c in cs.load_cuts(rsl, cs.load_grids(rsl))
               if c[0] == name)
    _, cfg, axes, slo, product = cut
    st, _ = rsl.sweep(cfg, axes, slo_us=slo, product=product)
    return cs.full_digest(jax.tree.map(np.asarray, st))


@pytest.mark.parametrize("name", [n for n in cs.CUT_DIGESTS
                                  if n != "features cut"])
def test_load_cut_digests_match_jax(name):
    assert cut_digest(name) == cs.CUT_DIGESTS[name]


def test_load_grids_follow_paper_figs():
    """The grids are ``paper_figs``' own: its settings and rates."""
    from benchmarks import paper_figs as pf
    from benchmarks.serving_bench import LOAD_FRACS
    assert cs.LOAD_FRACS == LOAD_FRACS
    assert cs.LOADLAT_EV8MS == pf._LOADLAT_EV8MS
    assert cs.OPENLOOP_EV8MS == pf._OPENLOOP_EV8MS
    assert cs.LOAD_SEEDS == pf.LOADLAT_SEEDS == pf.OPENLOOP_SEEDS
    assert cs.CHAOS_RATES == pf.CHAOS_RATES
    assert cs.LOAD_SLO["excess"] == pf.EXCESS_TAIL_SLO
    for f in cs.LOAD_FRACS + (1.1, 1.5, 3.0):
        assert cs.loadlat_rate(f) == pf._loadlat_rate(f)
        assert cs.openloop_rate(f) == pf._openloop_rate(f)
    grids = {g[0]: g for g in cs.load_grids(rsl)}
    assert len(grids["loadlat_sweep"][2]["policy"]) == 168
    assert len(grids["openloop_loadlat"][2]["policy"]) == 108
    assert len(grids["excess_tail"][2]["policy"]) == 18
    assert sum(n.startswith("chaos") for n in grids) == 7
