"""The port's ``fused_chunk`` (its plain version, on CPU tensors) against
the JAX package's Pallas ``fused_chunk`` in interpret mode, as
``test_torch_simstep.py`` holds it, under keyed traffic: each ``ks_*``
policy closed loop, the CRCW baseline open loop, and the four as a merged
set.  The same mid-run state, 128 events on both sides, every leaf.
Tolerance: exact equality.  The CUDA kernel itself is held against this
plain version on the card by ``chip_smoke.py`` (phase 3d)."""

import pytest

from test_torch_simstep import check_config

KEYED = dict(n_keys=256, n_locks=8)


@pytest.mark.parametrize("kw", [
    dict(policy="ks_erew", zipf_theta=1.2, **KEYED),
    dict(policy="ks_crew", zipf_theta=0.99, **KEYED),
    dict(policy="ks_jbsq", zipf_theta=0.5, **KEYED),
    dict(policy="fifo", wl_open=True, wl_rate=0.5, **KEYED),
    dict(policy="ks_crew", policy_set=("fifo", "ks_erew", "ks_crew",
                                       "ks_jbsq"), **KEYED),
], ids=["erew", "crew", "jbsq", "crcw-open", "merged"])
def test_keyed_paths_match_pallas_kernel(kw):
    check_config(**kw)
