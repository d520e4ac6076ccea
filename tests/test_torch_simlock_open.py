"""Open-loop arrivals (``wl_open``) against the JAX package's compiled
sweep at the golden-digest scale: each core parks on a pending ARRIVAL
event, an epoch begins at its true arrival time and its latency includes
the queueing, so a rate past saturation backlogs the cores (arrivals in
the past when they fire).  A single policy over loads from light to 3x
capacity, and a merged set shaped like ``paper_figs.openloop_loadlat``
(fifo / shfl / libasl at SLO 300).  Every leaf and summary is equal
(level 1).  Tolerance: exact equality."""

import golden_digests as gd
from test_torch_simlock import compare_grid

# paper_figs._openloop_rate(frac) for the fig1 calibration: rate = frac /
# sum_c cs_c / base_c.
CAPACITY = 1.0 / sum(cs / b for cs, b in zip(
    [3.0] * 4 + [3.0 * 3.75] * 4, [6.0] * 4 + [6.0 * 1.8] * 4))


def test_open_loop_loads_match_reference():
    rates = [f * CAPACITY for f in (0.2, 0.9, 1.1, 3.0)]
    st, summ = compare_grid({"arrival_rate": rates}, policy="libasl",
                            wl_open=True, wl_process="poisson",
                            wl_service="lognormal", wl_cv=1.0,
                            slo_us=300.0)
    # Past saturation the cores are backlogged: their next arrival is
    # already due when the epoch ends.
    assert (st.arr_t[3] < st.t[3]).any()
    assert summ[3]["ep_p99_all_us"] > 1000.0


def test_merged_open_loop_grid_matches_reference():
    axes = {"policy": ["fifo", "shfl", "libasl", "fifo", "libasl"],
            "arrival_rate": [f * CAPACITY for f in (0.4, 0.8, 0.6, 1.1,
                                                    1.1)],
            "slo_us": [1e9, 1e9, 300.0, 1e9, 300.0],
            "seed": [0, 1, 2, 3, 4],
            "sim_time_us": [gd.SIM_US, 3000.0, gd.SIM_US, 2500.0, 3500.0]}
    compare_grid(axes, product=False, slo_us=300.0, wl_open=True,
                 wl_process="mmpp", wl_burst=4.0, wl_service="bimodal",
                 wl_mix=0.2)
