"""The JAX package's final state of ``chip_smoke.py``'s features cut
(``feature_cut``: the seven policies merged, MMPP arrivals, the four
service distributions side by side, churn, straggling, preemption and
the histograms, 1,000 us), recomputed, against its ``CUT_DIGESTS``.
Tolerance: exact equality."""

from test_torch_figure_digests_load import cs, cut_digest


def test_features_cut_digest_matches_jax():
    assert cut_digest("features cut") == cs.CUT_DIGESTS["features cut"]
