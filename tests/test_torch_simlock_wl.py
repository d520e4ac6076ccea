"""Stochastic workloads (``wl``, closed loop) against the JAX package's
compiled sweep at the golden-digest scale: each service distribution (as
the per-core ``wl_service`` column, one per cell, and mixed within a
cell) under Poisson arrivals, and the closed arrival process (MMPP, the
six workload axes and a merged load grid are in
``test_torch_simlock_wl_load.py``).  Every draw goes through XLA's own
f32 ``log1p`` / ``exp`` / ``erf_inv``, so every leaf and summary is equal
(level 1).  Tolerance: exact equality."""

from test_torch_simlock import compare_grid

SERVICES = ("det", "exp", "lognormal", "bimodal")


def test_services_and_service_column_match_reference():
    cols = [(s,) * 8 for s in SERVICES] + [SERVICES * 2]
    st, _ = compare_grid({"wl_service_per_core": cols}, policy="fifo",
                         wl=True, wl_process="poisson", wl_rate=0.8,
                         wl_cv=2.0, wl_mix=0.3, wl_mix_scale=8.0)
    assert (st.svc_scale[1:] != 1.0).any(dim=1).all()


def test_closed_process_matches_reference():
    compare_grid({"seed": [0, 1], "n_cores": [6, 8]}, policy="tas",
                 w_big=4.0, wl=True, wl_process="closed", wl_rate=1.7,
                 wl_service="exp")
