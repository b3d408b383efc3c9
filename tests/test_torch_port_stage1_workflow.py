"""The port's two-stage workflow: Stage-I fits whose checkpoints graft into
the Stage-II translators, as tests/test_two_stage_workflow.py runs it for
``egot2x``.

Stage I: ``LookingAtMe`` (``BaselineLSTM``), ``TalkingToMe``
(``TTMBaselineLSTM``) and ``ActiveSpeakerDetection`` (``TalkNetWithHeads``)
each fit one epoch of two tiny batches through the port's ``Trainer`` on
the CPU and write a checkpoint. Stage II: ``graft_stage1`` loads those
checkpoints into ``TalkingToMe2Loader``'s 3-task translator and
``ActiveSpeakerDetection2Loader``'s ASD translator, whose backbone
tensors (weights and BN statistics) must equal the Stage-I models'
bit for bit. Also: the ASD checkpoint carries the BN statistics the epoch
moved and the learning-rate scheduler, and a resumed fit goes on from
them; the ASD task's validation against the JAX task's
(``finalize_validation`` 1e-6, scores rtol 1e-4).
"""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.models.asd  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.tasks.asd import ActiveSpeakerDetection as JaxASD  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.checkpoint import load_checkpoint  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.tasks.asd import ActiveSpeakerDetection  # noqa: E402
from egot2x_torch.tasks.asd_2loader import (  # noqa: E402
    ActiveSpeakerDetection2Loader)
from egot2x_torch.tasks.lam import LookingAtMe  # noqa: E402
from egot2x_torch.tasks.ttm import TalkingToMe  # noqa: E402
from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader  # noqa: E402
from egot2x_torch.train.trainer import Trainer  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

B, IMG = 2, 32
ASD_T, FACE = 15, 40
LR, DECAY = 1e-4, 0.95


def _lam_batch(rng, i):
    return dict(frames=rng.standard_normal((B, 7, IMG, IMG, 3)).astype(
        np.float32), label=np.array([0, 1], np.int32),
        uid=[f"lam{i}_{j}" for j in range(B)])


def _ttm_batch(rng, i):
    t = 15
    return dict(frames=rng.standard_normal((B, t, IMG, IMG, 3)).astype(
        np.float32), audio=(rng.standard_normal((B, t * 16000 // 30))
                            * 0.1).astype(np.float32),
        label=np.array([1, 0], np.int32), seg_id=[f"s{i}_{j}" for j in
                                                  range(B)],
        start=[0] * B, end=[t] * B)


def _asd_batch(rng, i):
    return dict(mfcc=rng.standard_normal((B, 4 * ASD_T, 13)).astype(
        np.float32), faces=rng.uniform(0, 255, (B, ASD_T, FACE, FACE)).astype(
        np.float32), labels=rng.integers(0, 2, (B, ASD_T)).astype(np.int32))


STAGE1 = {
    "lam": (LookingAtMe, dict(model="BaselineLSTM", weights=[0.136, 0.864],
                              lr=5e-4), _lam_batch),
    "ttm": (TalkingToMe, dict(model="TTMBaselineLSTM",
                              weights=[0.266, 0.734], lr=5e-4, wd=1e-4),
            _ttm_batch),
    "asd": (ActiveSpeakerDetection, dict(model="TalkNetWithHeads", lr=LR,
                                         lr_decay=DECAY), _asd_batch),
}


def _fit(name, root, epochs=1, resume_from=None):
    cls, cfg, make = STAGE1[name]
    rng = np.random.default_rng(len(name))
    train = [make(rng, i) for i in range(2)]
    val = [make(rng, i + 2) for i in range(2)]
    task = cls(Config(cfg), device="cpu")
    trainer = Trainer(task, max_epochs=epochs, default_root_dir=str(root),
                      seed=5, device="cpu")
    state = trainer.fit(train, val, resume_from=resume_from)
    return task, state, trainer, os.path.join(str(root), "checkpoints")


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """One epoch of each Stage-I task: (task, state, checkpoint directory,
    the model's weights before the epoch) by name."""
    out = {}
    for name in STAGE1:
        cls, cfg, _ = STAGE1[name]
        initial = cls(Config(cfg), device="cpu").build_state(5).model
        task, state, trainer, ckpt = _fit(
            name, tmp_path_factory.mktemp(name))
        out[name] = dict(task=task, state=state, ckpt=ckpt,
                         initial=initial.state_dict(),
                         metrics=trainer.metrics_history)
    return out


def _subtree(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _assert_grafted(backbone, stage1_state, prefix):
    want = _subtree(stage1_state, prefix)
    for k, v in backbone.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_stage1_fits_write_checkpoints_with_their_metrics(stage1):
    for name, checkpoint_metric in (("lam", "val_mAP"), ("ttm", "val_mAP"),
                                    ("asd", "val_acc")):
        run = stage1[name]
        assert os.path.exists(os.path.join(run["ckpt"], "last.json"))
        assert run["task"].checkpoint_metric == checkpoint_metric
        metrics = run["metrics"][0]
        assert 0.0 <= metrics[checkpoint_metric] <= 1.0
        saved = load_checkpoint(run["ckpt"])
        assert saved["step"] == 2
        for k, v in run["state"].model.state_dict().items():
            assert torch.equal(saved["model"][k], v), (name, k)


def test_stage1_checkpoints_graft_into_the_ttm_translator(stage1):
    cfg = Config(model="TaskFusionMFTransformer3Task", weights=[0.5, 0.5],
                 lr=1e-3, hidden_dim=64, num_heads=4, num_layers=1,
                 dropout=0.0, lam_checkpoint=stage1["lam"]["ckpt"],
                 ttm_checkpoint=stage1["ttm"]["ckpt"],
                 asd_checkpoint=stage1["asd"]["ckpt"])
    model = TalkingToMe2Loader(cfg, device="cpu").build_state(0).model
    _assert_grafted(model.lam_model, stage1["lam"]["state"].model
                    .state_dict(), "")
    _assert_grafted(model.ttm_model, stage1["ttm"]["state"].model
                    .state_dict(), "")
    _assert_grafted(model.asd_model, stage1["asd"]["state"].model
                    .state_dict(), "model.")


def test_stage1_checkpoints_graft_into_the_asd_translator(stage1):
    cfg = Config(model="TaskFusionMFTransformer3TaskASD", lr=1e-4,
                 hidden_dim=64, lam_checkpoint=stage1["lam"]["ckpt"],
                 ttm_checkpoint=stage1["ttm"]["ckpt"],
                 asd_checkpoint=stage1["asd"]["ckpt"])
    translator = ActiveSpeakerDetection2Loader(
        cfg, device="cpu").build_state(0).model.translator
    _assert_grafted(translator.lam_model, stage1["lam"]["state"].model
                    .state_dict(), "")
    _assert_grafted(translator.ttm_model, stage1["ttm"]["state"].model
                    .state_dict(), "")
    _assert_grafted(translator.asd_model, stage1["asd"]["state"].model
                    .state_dict(), "model.")


def test_checkpoints_carry_statistics_and_the_scheduler(stage1, tmp_path):
    """The epoch moved every BN's running statistics, and the checkpoint
    holds them and the scheduler after 2 steps (lr 1e-4 * 0.95^2); a fit
    resumed from it runs epoch 1 from there (lr 1e-4 * 0.95^4 after)."""
    run = stage1["asd"]
    saved = load_checkpoint(run["ckpt"])
    stats = [k for k in saved["model"]
             if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert not torch.equal(saved["model"][k], run["initial"][k]), k
    assert saved["scheduler"]["last_epoch"] == 2
    np.testing.assert_allclose(saved["optimizer"]["param_groups"][0]["lr"],
                               LR * DECAY ** 2, rtol=1e-12)
    _, state, trainer, _ = _fit("asd", tmp_path, epochs=2,
                                resume_from=run["ckpt"])
    assert [m["epoch"] for m in trainer.metrics_history] == [1]
    assert state.step == 4
    np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"],
                               LR * DECAY ** 4, rtol=1e-12)


def test_asd_validation_matches_jax(stage1):
    """eval_step (per-track correct and total frames, scores), accumulate
    with a padding track, finalize, against the JAX task's, on the
    weights the Stage-I epoch trained."""
    run = stage1["asd"]
    task, state = run["task"], run["state"]
    variables = bridge.to_jax_variables(state.model)
    jax_model = jax_build("TalkNetWithHeads")
    eval_fn = jax.jit(lambda v, m, f: jax_model.apply(v, m, f))
    jax_task = object.__new__(JaxASD)
    jax_state = type("S", (), dict(
        apply_fn=staticmethod(lambda v, m, f, train=False:
                              eval_fn(v, m, f)),
        variables=staticmethod(lambda: variables)))
    ctx, jax_ctx = task.start_validation(), jax_task.start_validation()
    rng = np.random.default_rng(9)
    for valid in ([True, True], [True, False]):
        batch = dict(_asd_batch(rng, 0), valid=np.array(valid))
        got = task.eval_step(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        want = jax_task.eval_step(jax_state, batch)
        for k in ("correct", "total"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), rtol=1e-4,
                                   atol=1e-5)
        task.accumulate(ctx, got, batch)
        jax_task.accumulate(jax_ctx, want, batch)
    assert ctx == jax_ctx and ctx["total"] == 3 * ASD_T
    np.testing.assert_allclose(task.finalize_validation(ctx)["val_acc"],
                               jax_task.finalize_validation(jax_ctx)[
                                   "val_acc"], rtol=1e-6)
