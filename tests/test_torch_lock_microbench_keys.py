"""``examples/lock_microbench_torch.py`` against
``examples/lock_microbench.py``: the key-sharded matrix (every
registered policy on a Zipf-keyed multi-lock workload) at a short
horizon on the CPU, every printed row.  Tolerance: exact equality of
every printed row."""

from test_torch_lock_microbench import check_section


def test_keyshard_matrix(capsys):
    rows = check_section(capsys, "keyshard_matrix", locks=4, zipf=0.99,
                         n_keys=256, sim_time_us=600.0)
    assert len(rows) == 1 + 10
