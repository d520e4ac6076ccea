"""``paper_figs.keyshard``'s ``ks_crew`` and ``ks_jbsq`` grids cut to
4,000 us against the JAX package's compiled sweep, every leaf and summary
(the CRCW and ``ks_erew`` grids: ``test_torch_simlock_keyed.py``).
Tolerance: exact equality."""

from test_torch_simlock_keyed import check_keyshard_grid


def test_crew_grid_matches_reference():
    st, _ = check_keyshard_grid("crew")
    # The read/write draws ran: some epochs are writes.
    assert (st.cur_rw < 0.5).any() and (st.cur_rw < 1.0).all()


def test_jbsq_grid_matches_reference():
    check_keyshard_grid("jbsq")
