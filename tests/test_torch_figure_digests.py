"""The JAX package's final states of ``chip_smoke.py``'s full-length
Bench-1 (its two merged phases) and Bench-6 grids, recomputed, against
the digests that script holds the card to (``FIGURE_DIGESTS``; Bench-3
and Bench-5 are in ``test_torch_figure_digests_mix.py``, fig1 and the
energy grids in ``test_torch_simstep_figs.py``).  Tolerance: exact
equality."""

import pytest

from test_torch_simstep_figs import cs, reference_digest


@pytest.mark.parametrize("name", [n for n in cs.FIGURE_DIGESTS
                                  if n.startswith(("bench1", "bench6"))])
def test_bench_digests_match_jax(name):
    assert reference_digest(name) == cs.FIGURE_DIGESTS[name]
