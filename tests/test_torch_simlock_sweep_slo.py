"""The port's ``sweep_slo`` against the JAX package's on a keyed config
and a ``wl`` config, leaf for leaf, at the golden-digest scale (the fig1
and Bench-1 programs and ``init_state``: ``test_torch_simlock_init.py``).
Tolerance: exact equality."""

import pytest

import golden_digests as gd
from test_torch_simlock_init import check_sweep_slo


@pytest.mark.parametrize("name", ["keyed", "wl"])
def test_sweep_slo_matches_reference(name):
    check_sweep_slo(name, [gd.SLO_US, 400.0])
