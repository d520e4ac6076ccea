"""Key-sharded traffic (``n_keys``) against the JAX package's compiled
sweep: ``paper_figs.keyshard``'s grids (4,096 keys, the zipped theta /
lock-count columns over 16 padded locks) cut to 4,000 us at the golden
seed, every ``SimState`` leaf (its digest) and every summary equal, for
the CRCW baseline (plain ``fifo`` under keys) and ``ks_erew``;
``ks_crew`` and ``ks_jbsq`` are in ``test_torch_simlock_keyed_crew.py``.
Every key draw goes through glibc's ``powf`` as the port writes it
(``core/xla_math.py``), so this is level 1.  Tolerance: exact
equality."""

import sys
from pathlib import Path

import golden_digests as gd
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def check_keyshard_grid(label: str):
    """The figure's grid of ``label`` at the golden horizon: every leaf and
    summary equal to the JAX package's."""
    name, cfg, axes, slo, product = next(
        g for g in cs.keyshard_grids(sl) if g[0] == f"keyshard {label}")
    st, summ = compare_grid(axes, product, slo_us=slo, policy=cfg.policy,
                            n_keys=cfg.n_keys, n_locks=cfg.n_locks,
                            sim_time_us=gd.SIM_US, **cs.FIG1)
    assert (st.events > 1000).all()
    # Every cell contends its drawn locks: more than one in use unless the
    # lock-count column gives it one.
    used = [(st.cur_lock[i] < int(n)).all() for i, n in
            enumerate(axes["n_locks"])]
    assert all(used)
    return st, summ


def test_crcw_grid_matches_reference():
    check_keyshard_grid("crcw")


def test_erew_grid_matches_reference():
    check_keyshard_grid("erew")
