"""The port's ``Unified3Task`` eval step and validation against the JAX
package's: the tests of tests/test_torch_port_egot2g_eval.py, with their
shapes, weights, batches and tolerances, on this task (their own module,
so that each file's JAX compiles stay well within a minute of one
worker's time)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_port_egot2g_eval import (  # noqa: E402,F401
    _one_thread, evaluated, test_eval_step_matches_jax,
    test_validation_matches_jax)


@pytest.fixture(scope="module")
def task_name():
    return "Unified3Task"
