"""The port's ``init_state`` and ``sweep_slo`` against the JAX package's
(``rsl.init_state``, params at SLO 0; ``rsl.sweep_slo``, Figure 8b in one
call), leaf for leaf, on the fig1 and Bench-1 programs, a keyed config
and a ``wl`` config, at the golden-digest scale (``sweep_slo`` on the
last two in ``test_torch_simlock_sweep_slo.py``).  Tolerance: exact
equality."""

import numpy as np
import pytest

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock_resume import FIG1

BENCH1 = dict(FIG1, seg_noncrit_us=(1.0, 0.5, 0.5, 0.5),
              seg_cs_us=(2.0, 1.0, 3.0, 0.5), seg_lock=(0, 1, 0, 1),
              n_locks=2, inter_epoch_us=7.5)
CONFIGS = {
    "fig1": dict(FIG1, policy="libasl"),
    "bench1": dict(BENCH1, policy="libasl"),
    "keyed": dict(FIG1, policy="libasl", n_keys=256, n_locks=4,
                  zipf_theta=0.99),
    "wl": dict(FIG1, policy="libasl", wl=True, wl_process="mmpp",
               wl_burst=4.0, wl_service="exp"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("windows", [False, True])
def test_init_state_matches_reference(name, windows):
    kw = dict(CONFIGS[name], sim_time_us=gd.SIM_US)
    w0 = np.linspace(100.0, 800.0, 8).astype(np.float32) if windows \
        else None
    st = sl.init_state(sl.SimConfig(**kw), gd.SEED, w0, device="cpu")
    rst = rsl.init_state(rsl.SimConfig(**kw), gd.SEED,
                         None if w0 is None else w0.copy())
    assert st.t.ndim == 0 and st.window.shape == (8,)
    assert gd.digest_state(sl.to_reference(st)) == gd.digest_state(rst)


def check_sweep_slo(name: str, slos: list) -> None:
    kw = dict(CONFIGS[name], sim_time_us=gd.SIM_US)
    st = sl.sweep_slo(sl.SimConfig(**kw), slos, seed=gd.SEED, device="cpu")
    rst = rsl.sweep_slo(rsl.SimConfig(**kw), slos, seed=gd.SEED)
    assert st.t.shape == (len(slos),)
    assert gd.digest_state(sl.to_reference(st)) == gd.digest_state(rst)


@pytest.mark.parametrize("name", ["fig1", "bench1"])
def test_sweep_slo_matches_reference(name):
    check_sweep_slo(name, [40.0, gd.SLO_US, 400.0])


def test_entry_points_run_on_the_card_by_default():
    """With no ``device`` they ask for the CUDA device and raise here (no
    card) rather than run on the CPU; so does a resumable sweep."""
    cfg = sl.SimConfig(policy="fifo", sim_time_us=100.0)
    for call in (lambda: sl.init_state(cfg),
                 lambda: sl.sweep_slo(cfg, [80.0]),
                 lambda: sl.sweep(cfg, {"seed": [0]}, resume_dir="unused")):
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            call()
