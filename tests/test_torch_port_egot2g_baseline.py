"""The port's ``TaskPromptTransformer`` (the single-stream EgoT2-g
baseline) against the JAX package's: the prompt-model tests of
tests/test_torch_port_egot2g.py, with their shapes, weights, inputs and
tolerances, on this model (their own module, so that each file's JAX
compiles stay well within a minute of one worker's time)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_port_egot2g import (  # noqa: E402,F401
    _one_thread, logits, prompt, test_bridge_round_trips,
    test_forward_logits_match_jax, test_lam_task_runs_the_lam_trunk_only,
    test_port_names_load_through_jax_torch_import,
    test_predict_logits_match_jax,
    test_prompt_encoder_routes_to_flash_unmasked_only,
    test_random_variables_have_the_jax_tree_structure)


@pytest.fixture(scope="module")
def model_name():
    return "TaskPromptTransformer"
