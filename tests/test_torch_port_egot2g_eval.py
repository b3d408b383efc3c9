"""The port's EgoT2-g HHI eval step and validation against the JAX task's.

``egot2x_torch`` ``Unified3TaskTranslation`` against ``egot2x``'s (and,
in tests/test_torch_port_egot2g_unified_eval.py, ``Unified3Task``): from
the same seeded weights (the tasks and shapes of
tests/test_torch_port_egot2g_train.py), the task's ``eval_step`` on two
combined batches (the JAX one jitted, the port's encoding each task's
batch once where the JAX package encodes it twice) and the validation
over both, ``start_validation`` / ``accumulate`` / ``finalize_validation``.

Tolerances: the greedy logits over '0' and '1' rtol = atol = 1e-4, as the
prompt models' (tests/test_torch_port_egot2g.py); the teacher-forced
losses rtol 1e-5; the accuracies equal; the LAM and TTM mAP and
``val_loss`` 1e-6.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.translate.egot2g import HHI_G_FROZEN_KEYS  # noqa: E402
from test_torch_port_egot2g_train import (  # noqa: E402,F401
    B, T, _as, _batches, _one_thread, _tasks)
from test_torch_port_train import trunks_traced_once  # noqa: E402

TASKS = ("lam", "ttm", "asd")


@pytest.fixture(scope="module")
def task_name():
    """The task under test (tests/test_torch_port_egot2g_unified_eval.py
    overrides it)."""
    return "Unified3TaskTranslation"


@pytest.fixture(scope="module")
def evaluated(task_name):
    """Each side's eval-step outputs on two batches and its validation
    metrics over them."""
    task, state, jax_task, jstate = _tasks(task_name)
    # the JAX eval step encodes each task's batch twice: trunks traced once
    jax_eval = jax.jit(trunks_traced_once(jax_task.eval_step,
                                          HHI_G_FROZEN_KEYS))
    ctx, jctx = task.start_validation(), jax_task.start_validation()
    outputs = []
    for seed in (20, 21):
        batches = _batches(seed)
        ours = task.eval_step(state, _as("torch", batches))
        theirs = jax_eval(jstate, _as("jax", batches))
        task.accumulate(ctx, ours, batches)
        jax_task.accumulate(jctx, theirs, batches)
        outputs.append((ours, theirs))
    return dict(task=task, outputs=outputs,
                val=task.finalize_validation(ctx),
                jax_val=jax_task.finalize_validation(jctx))


@pytest.mark.parametrize("task", TASKS)
def test_eval_step_matches_jax(evaluated, task):
    """The greedy logits over '0' and '1' and the teacher-forced loss of
    each task."""
    rows = B * T if task == "asd" else B
    for ours, theirs in evaluated["outputs"]:
        assert ours[task].shape == theirs[task].shape == (rows, 2)
        np.testing.assert_allclose(ours[task].numpy(),
                                   np.asarray(theirs[task]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(ours[f"{task}_loss"]),
                                   float(theirs[f"{task}_loss"]), rtol=1e-5)


def test_validation_matches_jax(evaluated):
    ours, theirs = evaluated["val"], evaluated["jax_val"]
    assert sorted(ours) == sorted(theirs) == sorted(
        ["val_loss", "val_lam_acc", "val_ttm_acc", "val_asd_acc",
         "val_lam_mAP", "val_ttm_mAP"])
    for key, want in theirs.items():
        if key.endswith("_acc"):
            assert ours[key] == want, key
        else:
            np.testing.assert_allclose(ours[key], want, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    task = evaluated["task"]
    assert (task.checkpoint_metric, task.checkpoint_mode) == ("val_loss",
                                                              "min")
