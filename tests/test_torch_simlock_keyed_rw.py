"""The read/write gate of a merged set under keyed traffic: only
``ks_crew``'s cells draw ``STREAM_RW``, and a ``fifo`` cell beside it
keeps ``cur_rw == 1`` as under its own policy, closed and open loop,
against the JAX package's compiled sweep at the golden seed: every leaf
and summary.  Tolerance: exact equality."""

import pytest
import torch

from test_torch_simlock import compare_grid
from test_torch_simlock_keyed_open import KEYED, OPEN


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_merged_rw_gate_matches_reference(loop):
    axes = {"policy": ["fifo", "ks_crew", "fifo", "ks_crew"],
            "zipf_theta": [0.5, 0.5, 1.2, 1.2],
            "crew_wfrac": [0.5, 0.5, 0.2, 0.2]}
    kw = dict(OPEN, wl_rate=0.6) if loop == "open" else {}
    st, _ = compare_grid(axes, product=False, sim_time_us=600.0,
                         **KEYED, **kw)
    fifo = torch.tensor([0, 2])
    assert (st.cur_rw[fifo] == 1.0).all()
    assert (st.cur_rw[torch.tensor([1, 3])] < 1.0).all()
