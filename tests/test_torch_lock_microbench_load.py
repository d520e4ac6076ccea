"""``examples/lock_microbench_torch.py`` against
``examples/lock_microbench.py``: the load-latency (closed loop, Poisson
think, lognormal service) and open-loop sections at short horizons on
the CPU, every printed row (the key-sharded matrix in
``test_torch_lock_microbench_keys.py``, the others in
``test_torch_lock_microbench.py``).  Tolerance: exact equality of every
printed row."""

from test_torch_lock_microbench import PORT_EX, check_section


def test_loadlat(capsys):
    rows = check_section(capsys, "loadlat", fracs=(0.4, 3.0),
                         sim_time_us=1500.0)
    assert len(rows) == 1 + 2


def test_openloop(capsys):
    rows = check_section(capsys, "openloop", fracs=(0.4, 1.1),
                         sim_time_us=1500.0)
    assert len(rows) == 1 + 2


def test_load_rates_are_the_figures():
    """The example's own copies of ``paper_figs``' rate helpers."""
    from benchmarks import paper_figs
    for f in (0.2, 0.4, 0.9, 1.1, 1.5, 3.0):
        assert PORT_EX._loadlat_rate(f) == paper_figs._loadlat_rate(f)
        assert PORT_EX._openloop_rate(f) == paper_figs._openloop_rate(f)
