"""The port's ``fused_chunk`` (its plain version, on CPU tensors) against
the JAX package's Pallas ``fused_chunk`` in interpret mode, as
``test_torch_simstep.py`` holds it, on a merged policy set and on long
epochs (with the wakeup cost and the energy model on); and the JAX
package's final states of ``chip_smoke.py``'s full-length figure grids,
recomputed, against the digests that script holds the card to
(``FIGURE_DIGESTS``).  Tolerance: exact equality."""

import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import energy as renergy
from repro.core import simlock as rsl
from test_torch_simlock_bench1 import BENCH1
from test_torch_simstep import check_config

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

ALL7 = ("fifo", "tas", "prop", "libasl", "edf", "shfl", "dvfs_race")
POWER = renergy.amp_power((1, 1, 1, 1, 0, 0, 0, 0))


@pytest.mark.parametrize("member", ["tas", "shfl"])
def test_merged_set_matches_pallas_kernel(member):
    check_config(policy=member, policy_set=ALL7, wakeup_us=1.0, **POWER,
                 **BENCH1)


@pytest.mark.parametrize("policy", ["libasl", "dvfs_race"])
def test_long_epochs_match_pallas_kernel(policy):
    check_config(policy=policy, long_epoch_prob=0.3, long_epoch_scale=5.0,
                 wakeup_us=0.5, **POWER)


@functools.lru_cache(maxsize=None)
def _bench1_phase1():
    _, cfg, axes, slo, product = cs.figure_grids(rsl, renergy)[0]
    st, grid = rsl.sweep(cfg, axes, slo_us=slo, product=product)
    return cfg, jax.tree.map(np.asarray, st), grid


def reference_digest(name: str) -> str:
    """full_digest of the JAX package's final state of figure grid
    ``name`` (Bench-1's phase 2 from its phase 1's fifo P99)."""
    if name.startswith("bench1"):
        cfg, st, grid = _bench1_phase1()
        if name.endswith("2"):
            p99 = rsl.sweep_summaries(cfg, st, grid)[0]["ep_p99_all_us"]
            _, cfg, axes, slo, product = cs.bench1_phase2(cfg, p99)
            st, _ = rsl.sweep(cfg, axes, slo_us=slo, product=product)
        return cs.full_digest(jax.tree.map(np.asarray, st))
    _, cfg, axes, slo, product = next(
        g for g in cs.figure_grids(rsl, renergy) if g[0] == name)
    st, _ = rsl.sweep(cfg, axes, slo_us=slo, product=product)
    return cs.full_digest(jax.tree.map(np.asarray, st))


@pytest.mark.parametrize("name", [n for n in cs.FIGURE_DIGESTS
                                  if n.startswith(("fig1", "energy"))])
def test_figure_digests_match_jax(name):
    """fig1 and energy_efficiency grids (the Bench grids:
    ``test_torch_figure_digests.py``)."""
    assert reference_digest(name) == cs.FIGURE_DIGESTS[name]
