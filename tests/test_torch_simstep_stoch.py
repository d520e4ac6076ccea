"""The port's ``fused_chunk`` (its plain version, on CPU tensors) against
the JAX package's Pallas ``fused_chunk`` in interpret mode, as
``test_torch_simstep.py`` holds it, on the stochastic paths: a closed-loop
``wl`` config (MMPP think, lognormal service), an open-loop one with the
streaming histograms, and one with all three faults.  The same mid-run
state, 128 events on both sides, every leaf.  Tolerance: exact
equality.  The CUDA kernel itself is held against this plain version on
the card by ``chip_smoke.py`` (its stochastic instantiation)."""

import pytest

from test_torch_simstep import BENCH1, check_config


@pytest.mark.parametrize("kw", [
    dict(policy="libasl", wl=True, wl_process="mmpp", wl_burst=4.0,
         wl_service="lognormal", wl_cv=2.0),
    dict(policy="shfl", wl_open=True, wl_rate=0.3, wl_service="bimodal",
         wl_mix=0.2, hist=True, hist_warmup=4, **BENCH1),
    dict(policy="tas", preempt_rate=0.1, straggle_rate=0.1, churn_rate=0.2,
         churn_period_us=50.0, fault_mask=(0.0,) * 4 + (1.0,) * 4),
], ids=["wl", "wl_open+hist", "faults"])
def test_stochastic_paths_match_pallas_kernel(kw):
    check_config(**kw)
