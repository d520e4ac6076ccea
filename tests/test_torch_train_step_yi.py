"""One training step of the port against the JAX package's, compiled, on
yi-tiny in f32 (a scanned stack: the port's layers are views of the
stacked leaves) with 1 and 2 microbatches; what is compared and the
tolerances are ``tests/test_torch_train_step.py``'s."""

import pytest

from test_torch_train_step import check_one_step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_yi_tiny_step_matches_jitted_reference(microbatches):
    check_one_step("yi-6b", microbatches)
