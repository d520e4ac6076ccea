"""Streaming latency histograms (``hist``) against the JAX package's
compiled sweep at the golden-digest scale: alone, and with a stochastic
workload; the bucket counts are every leaf (u32, compared by bytes), and
``summarize``'s histogram keys, ``hist_tail`` and ``fleet_tail`` equal
the reference's, also where the latency rings wrapped (``epcap=64``:
``tail_truncated``, the histogram percentiles promoted).  Tolerance:
exact equality."""

import jax
import numpy as np

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid, summary_digests


def test_hist_alone_matches_reference():
    st, summ = compare_grid({"n_cores": [4, 8], "seed": [0, 1]},
                            policy="tas", hist=True, hist_warmup=8)
    assert st.ep_hist.shape[2] == 512 and int(st.ep_hist.sum()) > 0
    assert all("ep_p999_hist_all_us" in s for s in summ)


def test_hist_with_wl_and_wrapped_rings_match_reference():
    """epcap=64: every ring wraps; ``summarize`` flags it and promotes the
    histogram percentiles and goodput; ``hist_tail`` and ``fleet_tail``
    on the whole state, with and without an SLO."""
    kw = dict(policy="libasl", hist=True, hist_buckets=64, hist_lo_us=1.0,
              hist_hi_us=1e4, epcap=64, wl=True, wl_process="poisson",
              wl_service="lognormal", wl_rate=1.5, sim_time_us=gd.SIM_US)
    axes = {"slo_us": [40.0, 200.0], "seed": [0, 1]}
    st, summ = compare_grid(axes, slo_us=None, **kw)
    assert all(s["tail_truncated"] for s in summ)
    cfg, rcfg = sl.SimConfig(**kw), rsl.SimConfig(**kw)
    rst, _ = rsl.sweep(rcfg, axes, seed=gd.SEED)
    for slo in (None, 120.0):
        assert summary_digests([sl.fleet_tail(cfg, st, slo)]) == \
            summary_digests([rsl.fleet_tail(rcfg, rst, slo)])
        for i in range(2):
            got = sl.hist_tail(cfg, sl.to_reference(st).ep_hist[i],
                               sl.to_reference(st).cs_hist[i], slo)
            want = rsl.hist_tail(rcfg, np.asarray(rst.ep_hist[i]),
                                 np.asarray(rst.cs_hist[i]), slo)
            assert summary_digests([got]) == summary_digests([want])
    # fleet_tail takes the reference's numpy state too.
    assert summary_digests([sl.fleet_tail(cfg, jax.tree.map(
        np.asarray, rst))]) == summary_digests([rsl.fleet_tail(rcfg, rst)])
