"""The port's plain step on ``chip_smoke.py``'s keyed cuts (the keyshard
figure's 36 cells merged, 1,500 us; the fifo / ks_crew open loop, 500
us): its final states equal the JAX package's digests
(``KEYSHARD_CUT_DIGESTS``, recomputed in
``test_torch_figure_digests_keys.py``), the states the card holds its
kernel to.  Tolerance: exact equality."""

import pytest

from repro_torch.core import simlock as sl
from test_torch_figure_digests_keys import cs


@pytest.mark.parametrize("name", sorted(cs.KEYSHARD_CUT_DIGESTS))
def test_plain_step_reproduces_keyed_cuts(name):
    _, cfg, axes, slo, product = next(
        g for g in cs.keyshard_cuts(sl) if g[0] == name)
    st, _ = sl.sweep(cfg, axes, slo_us=slo, product=product, device="cpu")
    assert cs.full_digest(sl.to_reference(st)) == \
        cs.KEYSHARD_CUT_DIGESTS[name]
