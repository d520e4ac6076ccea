"""The port's resumable sweep over a stochastic grid (``wl`` closed loop,
Poisson think, exponential service, four seeds; 1,000 us, the plain
step's draws being dear on the CPU) in chunks of 1, 3 and 8: one-shot,
resumable and resumed runs against each other and the JAX package's
sweep, leaf for leaf (``test_torch_simlock_resume.py`` has the merged
grid and the refusals).  Tolerance: exact equality."""

import pytest

from test_torch_simlock_resume import FIG1, check_resume

STOCH = (dict(FIG1, policy="libasl", sim_time_us=1000.0, wl=True,
              wl_process="poisson", wl_service="exp"),
         {"seed": [0, 1, 2, 3], "slo_us": [80.0, 40.0, 200.0, 80.0]})


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_stochastic_grid_resumes_bit_identical(chunk, tmp_path):
    check_resume(STOCH, chunk, tmp_path)
