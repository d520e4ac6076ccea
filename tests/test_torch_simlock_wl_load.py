"""Stochastic workloads against the JAX package's compiled sweep at the
golden-digest scale: the MMPP arrival process with the six workload axes
(``arrival_rate``, ``cv``, ``mix``, ``mix_scale``, ``burstiness``,
``burst_len``) zipped, and a merged policy set shaped like
``paper_figs.loadlat_sweep``: every leaf and summary equal (level 1;
the diurnal ramp is in ``test_torch_simlock_diurnal.py``).  Tolerance:
exact equality."""

import golden_digests as gd
from test_torch_simlock import compare_grid


def test_mmpp_and_the_six_workload_axes_match_reference():
    """The axes zipped over five cells, a config whose gate is off (the
    axes turn it on), lognormal and bimodal cores side by side."""
    axes = {"arrival_rate": [0.3, 0.8, 1.0, 2.5, 6.0],
            "cv": [0.5, 1.0, 2.0, 3.0, 1.0],
            "mix": [0.0, 0.1, 0.3, 0.5, 0.9],
            "mix_scale": [2.0, 10.0, 4.0, 30.0, 1.5],
            "burstiness": [1.0, 4.0, 9.0, 2.0, 16.0],
            "burst_len": [1.0, 2.5, 8.0, 32.0, 0.5]}
    st, _ = compare_grid(axes, product=False, policy="libasl",
                         wl_process="mmpp",
                         wl_service_per_core=("lognormal", "bimodal") * 4)
    assert (st.wl_on == 0).any() and (st.wl_on == 1).any()


def test_merged_load_grid_matches_reference():
    """``loadlat_sweep``'s shape: fifo / tas (w_big 8) / prop / libasl
    (SLO 200) as one merged set, each at its own load, seed and horizon
    (zipped), Poisson think and lognormal service with cv 1."""
    axes = {"policy": ["fifo", "tas", "prop", "libasl", "libasl"],
            "arrival_rate": [0.2, 0.9, 3.0, 0.6, 3.0],
            "w_big": [1.0, 8.0, 1.0, 1.0, 1.0],
            "slo_us": [1e9, 1e9, 1e9, 200.0, 200.0],
            "seed": [0, 1, 2, 3, 4],
            "sim_time_us": [gd.SIM_US, 3000.0, 2500.0, gd.SIM_US, 2000.0]}
    compare_grid(axes, product=False, slo_us=200.0, wl=True,
                 wl_process="poisson", wl_service="lognormal", wl_cv=1.0)
