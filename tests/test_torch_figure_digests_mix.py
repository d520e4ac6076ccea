"""The JAX package's final states of ``chip_smoke.py``'s full-length
Bench-3 (long-epoch mix) and Bench-5 (contention, the ``seg_noncrit_us``
table axis) grids, recomputed, against the digests that script holds the
card to (``FIGURE_DIGESTS``).  Tolerance: exact equality."""

import pytest

from test_torch_simstep_figs import cs, reference_digest


@pytest.mark.parametrize("name", [n for n in cs.FIGURE_DIGESTS
                                  if n.startswith(("bench3", "bench5"))])
def test_mix_and_contention_digests_match_jax(name):
    assert reference_digest(name) == cs.FIGURE_DIGESTS[name]
