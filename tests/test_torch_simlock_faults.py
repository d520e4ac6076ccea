"""Fault injection against the JAX package's compiled sweep at the
golden-digest scale: holder preemption, straggler spikes and core churn,
each alone and all together (the three rate axes zipped, so one cell per
mix), with a ``fault_mask`` that makes only the little cores eligible
(``paper_figs.chaos_collapse``'s setup), and the two scale axes.  Every
leaf and summary is equal (level 1; the stall is Exp through XLA's own
f32 ``log1p``).  Tolerance: exact equality."""

from test_torch_simlock import compare_grid

LITTLE_ONLY = (0.0,) * 4 + (1.0,) * 4


def test_faults_alone_and_together_match_reference():
    axes = {"preempt_rate": [0.0, 0.2, 0.0, 0.0, 0.1],
            "straggle_rate": [0.0, 0.0, 0.3, 0.0, 0.1],
            "churn_rate": [0.0, 0.0, 0.0, 0.3, 0.2]}
    st, summ = compare_grid(axes, product=False, policy="fifo",
                            fault_mask=LITTLE_ONLY, churn_period_us=100.0)
    assert len({s["throughput_cs_per_s"] for s in summ}) == 5


def test_fault_scales_and_policies_match_reference():
    """The two scale axes on a libasl grid (SLO in its slack), and the
    chaos figure's preemption axis on tas with every core eligible."""
    compare_grid({"preempt_rate": [0.05, 0.2], "preempt_scale": [10.0, 80.0],
                  "straggle_scale": [2.0, 20.0]}, product=False,
                 policy="libasl", straggle_rate=0.1, fault_mask=LITTLE_ONLY,
                 slo_us=300.0)
    compare_grid({"preempt_rate": [0.0, 0.05, 0.2]}, policy="tas",
                 w_big=0.15, preempt_scale_us=50.0)
