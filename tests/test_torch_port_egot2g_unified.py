"""The port's ``Unified3Task`` (the single-stream EgoT2-g baseline on
``TaskPromptTransformer``) against the JAX package's: the tests of
tests/test_torch_port_egot2g_train.py, with their shapes, weights,
batches and tolerances, on this task (their own module, so that each
file's JAX compiles stay within a minute of one worker's time)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_port_egot2g_train import (  # noqa: E402,F401
    _one_thread, run, test_adam_steps_match_jax,
    test_frozen_backbones_stay_bit_identical,
    test_train_step_gradients_match_jax, test_train_step_loss_matches_jax,
    test_trainer_fits_on_a_combined_loader)


@pytest.fixture(scope="module")
def task_name():
    return "Unified3Task"
